"""Start the longest test files first when the suite runs on pytest-xdist.

With `--dist loadfile`, pytest-xdist (3.8.0) hands each worker whole files
in the order of its work queue, and by default it orders that queue by the
number of tests in a file, most first (`--loadscope-reorder`). The suite's
longest files hold one or two tests each (a JAX step compiled with
interpret-mode Pallas kernels), so they were queued behind every other
file and the run's wall was about a sixth of everything else plus the
longest file. Here the reordering is turned off, and the collected items
are sorted, stably, so that the files start longest first, by their
measured time (SECONDS). The tests inside a file keep their order.

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

#: seconds per file, the sum over its tests of a tier-1 run's --junitxml
#: (6 workers on an 8-core CPU host); refresh it from a whole run when a
#: file is added or its time moves; a file not listed counts as 0
SECONDS = {
    "test_ysharded.py": 899,
    "test_distributed.py": 652,
    "test_fused_step.py": 507,
    "test_fused_streaming.py": 502,
    "test_fused_sharded.py": 432,
    "test_dispatch.py": 392,
    "test_torch_step.py": 286,
    "test_torch_io_cli.py": 262,
    "test_pallas_integrate.py": 199,
    "test_pallas_raycast.py": 198,
    "test_torch_streaming.py": 140,
    "test_torch_mapping.py": 129,
    "test_torch_spans.py": 122,
    "test_torch_volume.py": 120,
    "test_torch_sharded_integrate.py": 103,
    "test_mapping.py": 102,
    "test_torch_integrate.py": 94,
    "test_torch_march.py": 82,
    "test_torch_session.py": 74,
    "test_torch_sharded_fused.py": 60,
    "test_torch_tools.py": 59,
    "test_session.py": 57,
    "test_pallas_icp.py": 54,
    "test_pipeline.py": 51,
    "test_torch_raycast.py": 48,
    "test_torch_sharded_step.py": 45,
    "test_torch_bench.py": 41,
    "test_torch_icp_warped.py": 38,
    "test_sanitizers.py": 35,
    "test_torch_sharded_kernels.py": 31,
    "test_torch_icp.py": 29,
    "test_volume.py": 27,
    "test_tilegather.py": 25,
    "test_frontend.py": 23,
    "test_torch_foundations.py": 23,
    "test_torch_graph.py": 20,
    "test_torch_sanitizers.py": 18,
    "test_datasets.py": 16,
    "test_golden_trajectory.py": 14,
    "test_torch_frontend.py": 12,
    "test_icp.py": 12,
    "test_viz3d.py": 12,
    "test_torch_integrate_paths.py": 10,
    "test_torch_facewarp.py": 9,
    "test_torch_sharded_sizes.py": 8,
    "test_se3.py": 2,
    "test_intrinsics.py": 2,
    "test_io.py": 1,
}


def pytest_configure(config):
    # present only when pytest-xdist is loaded
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def _file_rank(name: str):
    return -SECONDS.get(name, 0)


def pytest_collection_modifyitems(session, config, items):
    # in collection order before the stable sort, so that every xdist
    # worker collects the same order (a set's order changes per process)
    files = sorted(dict.fromkeys(item.path.name for item in items), key=_file_rank)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers and len(files) > 2 * workers:
        files = files[:workers] + files[:-workers - 1:-1] + files[workers:-workers]
    rank = {name: k for k, name in enumerate(files)}
    items.sort(key=lambda item: rank[item.path.name])
