"""Start the longest test files first when the suite runs on pytest-xdist.

With `--dist loadfile`, pytest-xdist (3.8.0) hands each worker whole files
in the order of its work queue, and by default it orders that queue by the
number of tests in a file, most first (`--loadscope-reorder`). The suite's
longest files hold one or two tests each (a JAX step compiled with
interpret-mode Pallas kernels), so they were queued behind every other
file and the run's wall was about a sixth of everything else plus the
longest file. Here the reordering is turned off, and the collected items
are sorted, stably, so that the files start longest first: the four named
in FIRST, then the rest by their measured time. The tests inside a file
keep their order.

One exception to that order: at the start xdist gives each worker one
file and then, to every worker whose file holds at most two tests, a
second one queued behind it (`LoadScopeScheduling.schedule` and
`_reschedule`, xdist/scheduler/loadscope.py). The longest files hold one
or two tests, so the shortest files follow the first ones, one for each
worker, and the long files' workers start a short second file.

This file imports neither jax nor torch: tests/conftest.py must set the
JAX platform before jax is first imported.
"""

import os

#: the files that start first, in this order
FIRST = ("test_ysharded.py", "test_fused_step.py", "test_fused_streaming.py",
         "test_torch_step.py")

#: seconds per file, the sum over its tests of a tier-1 run's --junitxml
#: (6 workers on an 8-core CPU host); a file not listed counts as 0
SECONDS = {
    "test_distributed.py": 529,
    "test_fused_sharded.py": 344,
    "test_dispatch.py": 207,
    "test_pallas_integrate.py": 188,
    "test_torch_io_cli.py": 129,
    "test_pallas_raycast.py": 127,
    "test_mapping.py": 96,
    "test_torch_raycast.py": 70,
    "test_torch_integrate.py": 69,
    "test_torch_session.py": 56,
    "test_session.py": 38,
    "test_pipeline.py": 33,
    "test_pallas_icp.py": 32,
    "test_torch_icp_warped.py": 27,
    "test_torch_icp.py": 23,
    "test_frontend.py": 21,
    "test_tilegather.py": 20,
    "test_sanitizers.py": 19,
    "test_volume.py": 19,
    "test_icp.py": 15,
    "test_torch_foundations.py": 14,
    "test_torch_frontend.py": 14,
    "test_golden_trajectory.py": 12,
    "test_datasets.py": 12,
    "test_torch_facewarp.py": 9,
    "test_viz3d.py": 8,
    "test_intrinsics.py": 2,
    "test_se3.py": 2,
}


def pytest_configure(config):
    # present only when pytest-xdist is loaded
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def _file_rank(name: str):
    if name in FIRST:
        return (0, FIRST.index(name))
    return (1, -SECONDS.get(name, 0))


def pytest_collection_modifyitems(session, config, items):
    # in collection order before the stable sort, so that every xdist
    # worker collects the same order (a set's order changes per process)
    files = sorted(dict.fromkeys(item.path.name for item in items), key=_file_rank)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers and len(files) > 2 * workers:
        files = files[:workers] + files[:-workers - 1:-1] + files[workers:-workers]
    rank = {name: k for k, name in enumerate(files)}
    items.sort(key=lambda item: rank[item.path.name])
