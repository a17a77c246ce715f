"""Checkpoint and resume of a fusion session (port of
kinfu_tpu/io/checkpoint.py).

The whole session state (TSDF, weight and colour volumes, pose, model
maps, pose history, frame index and the exact configuration) goes through
one compressed npz in the JAX package's layout and meta JSON, so that a
checkpoint written by either package loads in the other. A streaming
session's checkpoint adds the grid's offset, `origin_vox`, and says
`"streaming": true` in its meta.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

_FORMAT_VERSION = 1


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, session) -> None:
    """Serialise a KinFuSession (pipeline/session.py) to `path` (.npz)."""
    state = session.state
    streaming = session.streaming
    extra = {}
    if streaming:
        extra["origin_vox"] = _np(state.origin_vox)
        state = state.kinfu
    arrays = {
        **extra,
        "tsdf": _np(state.vol.tsdf),
        "weight": _np(state.vol.weight),
        "color": _np(state.vol.color),
        "pose_R": _np(state.pose.R),
        "pose_t": _np(state.pose.t),
        "frame_count_dev": _np(state.frame_count),
        "pose_record": np.stack(session.pose_record, axis=0),
    }
    for i, (v, n) in enumerate(zip(state.model_vmaps, state.model_nmaps)):
        arrays[f"model_v{i}"] = _np(v)
        arrays[f"model_n{i}"] = _np(n)
    meta = {
        "version": _FORMAT_VERSION,
        "frame_count": session.frame_count,
        "levels": len(state.model_vmaps),
        "params": dataclasses.asdict(session.params),
        "intrinsics": dataclasses.asdict(session.intr),
        "streaming": streaming,
    }
    tmp = path + ".tmp"
    np.savez_compressed(tmp, meta=json.dumps(meta), **arrays)
    # numpy appends .npz to the temp name
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """Rebuild a KinFuSession on `device` from a checkpoint written by
    either package's `save_checkpoint`."""
    from kinfu_tpu_torch.pipeline.session import KinFuSession
    from kinfu_tpu_torch.pipeline.state import state_from_numpy, streaming_state_from_numpy

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        streaming = bool(meta.get("streaming", False))
        # JSON turns the config's tuples into lists
        params = KinFuParams(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in meta["params"].items()})
        intr = Intrinsics(**meta["intrinsics"])
        levels = meta["levels"]
        R = np.asarray(z["pose_R"], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, np.asarray(z["pose_t"], np.float32)
        arrays = {
            "tsdf": z["tsdf"],
            "weight": z["weight"],
            # older checkpoints stored the packed colour as uint32; packed
            # RGB <= 0x00FFFFFF, so the cast is lossless
            "color": np.asarray(z["color"]).astype(np.int32),
            "pose": T,
            "model_vmaps": [z[f"model_v{i}"] for i in range(levels)],
            "model_nmaps": [z[f"model_n{i}"] for i in range(levels)],
            "frame_count": z["frame_count_dev"],
        }
        if streaming:
            arrays["origin_vox"] = z["origin_vox"]
        pose_record = [np.asarray(m) for m in z["pose_record"]]
        frame_count = int(meta["frame_count"])

    session = KinFuSession(intr, params, device=device, streaming=streaming)
    from_numpy = streaming_state_from_numpy if streaming else state_from_numpy
    session.state = from_numpy(arrays, device=session.device)
    session.pose_record = pose_record
    session.frame_count = frame_count
    return session

