"""stream.moved_share: the % of the streaming shift's calls in the run that
moved voxels (a component of the shift other than 0), from the program's
device counter `volume/stream.py::SHIFT_COUNTS` (per device: calls, moves;
counted from the process's first frame, warm-up included), read once
after the run. None where the program has no such counter or made no
shift call (a fixed grid, the sharded step)."""


def read(ctx):
    from kinfu_tpu_torch.volume import stream

    counts = getattr(stream, "SHIFT_COUNTS", None)
    if not counts:
        return None
    calls = sum(int(c[0]) for c in counts.values())
    moved = sum(int(c[1]) for c in counts.values())
    if not calls:
        return None
    return 100.0 * moved / calls
