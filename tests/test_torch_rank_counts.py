"""The dry run's per-rank ``meta`` programs against real ranks, on the CPU.

For the six families at reduced size (``tests/_torch_rank_counts.py``:
training with 2 microbatches, prefill, decode), on a 2 × 2 and a
2 × 2 × 2 mesh: rank 0's sharded step counted on ``meta`` by
``launch.dryrun.analyze_rank_step`` (torch's ``fake`` process group, the
microbatches counted once and scaled) equals what every gloo rank counts
running the same step on the CPU with values (``launch.mesh.run_ranks``,
``OpAnalysis`` without trips): the FLOPs exactly, and the bytes received
by kind, the largest call and each distinct call's count, to the byte.
The last rank's ``meta`` counts equal rank 0's: one rank stands for all.
The CPU ranks run while the ``meta`` programs are counted.
"""
import math
import threading

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import meta_rank_mesh, run_ranks

import _torch_rank_counts as rc

MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _meta(arch, kind, shape, rank):
    cost, coll, *_ = dryrun.analyze_rank_step(get_config(arch, reduced=True), rc.SHAPES[kind], shape, rank=rank,
                                              microbatches=rc.MICROBATCHES if kind == "train" else 1)
    return {"flops": int(cost.flops), "by_kind": coll["by_kind"], "largest": coll["largest"], "calls": coll["calls"]}


@pytest.fixture(scope="module")
def counts():
    """{mesh name: (each gloo rank's counts, rank 0's meta counts, the last
    rank's meta counts)}: the ranks spawned first, the meta programs counted
    while they run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    real: dict = {}
    errors: list = []

    def spawn():
        try:
            for name, shape in MESHES.items():
                real[name] = run_ranks(rc.counts, shape, backend="gloo", device_type="cpu", timeout=600)
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    try:
        meta = {name: ({c: _meta(*c, shape, 0) for c in rc.CASES},
                       {c: _meta(*c, shape, math.prod(shape.values()) - 1) for c in rc.CASES})
                for name, shape in MESHES.items()}
    finally:
        t.join()
        torch.set_num_threads(prev)
    if errors:
        raise errors[0]
    return {name: (real[name], *meta[name]) for name in MESHES}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,kind", rc.CASES)
def test_a_meta_rank_counts_what_the_ranks_count(counts, arch, kind, mesh):
    real, first, last = counts[mesh]
    want = first[(arch, kind)]
    assert want["flops"] > 0 and want["by_kind"] and want["largest"] > 0
    if kind == "train":
        assert any(c > 1 for c, _ in want["calls"].values())     # the microbatches' calls, counted twice
    for r, got in enumerate(real):
        got = got[(arch, kind)]
        assert got["flops"] == want["flops"], (r, got["flops"], want["flops"])
        assert got["by_kind"] == want["by_kind"], (r, got["by_kind"], want["by_kind"])
        assert got["largest"] == want["largest"] and got["calls"] == want["calls"], r
    assert last[(arch, kind)] == want


def test_the_fake_backend_serves_meta_only():
    """A meta rank's mesh refuses a tensor off ``meta`` and refuses to
    start over a process group already up; the group is gone after."""
    from repro_torch.launch.mesh import all_reduce, make_mesh

    with meta_rank_mesh({"data": 2, "model": 2}, 3) as mesh:
        assert mesh.device.type == "meta" and mesh.backend == "fake" and mesh.coords == {"data": 1, "model": 1}
        assert all_reduce(torch.empty(4, device="meta"), "model", mesh).device.type == "meta"
        with pytest.raises(ValueError, match="on cpu on a mesh of meta"):
            all_reduce(torch.ones(4), "model", mesh)
        with pytest.raises(ValueError, match="fake backend serves the meta device only"):
            make_mesh({"data": 2, "model": 2}, device_type="cpu")
        with pytest.raises(RuntimeError, match="a process group is initialised"):
            with meta_rank_mesh({"model": 2}):
                pass
    assert not torch.distributed.is_initialized()
