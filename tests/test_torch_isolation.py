"""The port stands alone: no JAX, nothing of the reference package, the
CUDA card by default, and kernel wrappers that import and validate with
no nvcc and no card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro|ml_dtypes)(?:[.\s]|$)", re.M)


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=full_env, timeout=120
    )


def test_imports_with_jax_and_reference_blocked():
    r = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch, repro_torch.core\n"
        "import repro_torch.kernels.cost_matrix.ops, repro_torch.kernels.priority_requeue.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.core.migration, repro_torch.core.topology, repro_torch.sim\n"
        "import repro_torch.sim.grid, repro_torch.sim.interop\n"
        "import repro_torch.core.p2p, repro_torch.sim.p2p_grid, repro_torch.sim.bench_inputs\n"
        "import repro_torch.scenarios, repro_torch.scenarios.__main__\n"
        "import repro_torch.grid, repro_torch.grid.capacity, repro_torch.grid.runtime\n"
        "import repro_torch.grid.example\n"
        "import repro_torch.models.rglru, repro_torch.models.ssm, repro_torch.models.lm\n"
        "import repro_torch.models.decode, repro_torch.models.attention, repro_torch.models.interop\n"
        "import repro_torch.optim, repro_torch.optim.adamw8, repro_torch.optim.compress, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.runtime, repro_torch.runtime.train, repro_torch.launch.train\n"
        "import repro_torch.configs.shapes, repro_torch.runtime.serve, repro_torch.runtime.sharding\n"
        "import repro_torch.runtime.pspec, repro_torch.launch.mesh, repro_torch.launch.op_analysis\n"
        "import repro_torch.launch.dryrun, repro_torch._counting\n"
        "for n in repro_torch.scenarios.SCENARIOS:\n"
        "    repro_torch.scenarios.get_generator(n), repro_torch.scenarios.get_verifier(n)\n"
        "repro_torch.configs.get_config('gemma2-9b')\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes') "
        "and sys.modules[m] is not None)\n"
        "print('LOADED', loaded)\n"
    )
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax, ml_dtypes or the reference package"
    assert "import jax" not in text and "import ml_dtypes" not in text


def test_ops_import_and_build_nothing_without_nvcc():
    r = _run(
        "import repro_torch.kernels.cost_matrix.ops, repro_torch.kernels.priority_requeue.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.serving\n"
        "from repro_torch.kernels import _build\n"
        "print('CACHED', _build.library.cache_info().currsize)\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('NONVCC', e)\n",
        PATH="", CUDA_HOME=str(ROOT / "no-cuda-here"),
    )
    assert r.returncode == 0, r.stderr
    assert "CACHED 0" in r.stdout
    assert "NONVCC nvcc not found" in r.stdout


def _default_device_calls():
    from repro_torch.configs import get_config
    from repro_torch.core import (
        DianaScheduler, Job, JobPack, SitePack, TierPack, replay_place, reprioritize,
        select_peers_batch, total_cost_matrix,
    )
    from repro_torch.core.migration import select_peer_targets
    from repro_torch.launch import serve, train
    from repro_torch.models import LM
    from repro_torch.core import GossipExchange, NetworkLink, PeerScheduler, SiteState, single_peer
    from repro_torch.scenarios import run_scenario
    from repro_torch.sim import GridSim, P2PGridSim, paper_grid_spec

    one = np.ones(1)
    site = lambda: ({"a": SiteState(name="a", capacity=1.0)},  # noqa: E731
                    {"a": NetworkLink(bandwidth_Bps=1.0)})
    return {
        "PeerScheduler": lambda: PeerScheduler("a", *site()),
        "single_peer": lambda: single_peer(*site()),
        "GossipExchange": lambda: GossipExchange([]),
        "P2PGridSim": lambda: P2PGridSim(paper_grid_spec()),
        "run_scenario": lambda: run_scenario("diurnal_flash"),
        "DianaScheduler": lambda: DianaScheduler({}, {}),
        "SitePack.from_scheduler": lambda: SitePack.from_scheduler({}, {}),
        "SitePack.from_arrays": lambda: SitePack.from_arrays(
            ["a"], cap=one, queue=one, work=one, load=one, bw=one, loss=one, rtt=one,
            mss=one, alive=[True]),
        "JobPack.from_jobs": lambda: JobPack.from_jobs([]),
        "GridSim": lambda: GridSim(paper_grid_spec()),
        # a TierPack lives on its SitePack's device; the pack's default is the card
        "TierPack.from_site_pack": lambda: TierPack.from_site_pack(SitePack.from_arrays(
            ["a"], cap=one, queue=one, work=one, load=one, bw=one, loss=one, rtt=one,
            mss=one, alive=[True])),
        # the migration passes follow tensor inputs and go to the card on NumPy ones
        "select_peers_batch": lambda: select_peers_batch(
            [Job(user="u")], "local", [9.0], [5.0], ["a", "b"], np.ones((1, 2)), np.ones((1, 2))),
        "select_peer_targets": lambda: select_peer_targets(
            [False], [9.0], [5.0], [False, False], np.ones((1, 2)), np.ones((1, 2))),
        "reprioritize": lambda: reprioritize([1.0], [1.0], [1.0], 1.0, 1.0),
        "replay_place": lambda: replay_place([], {}, {}),
        "total_cost_matrix": lambda: total_cost_matrix(
            one, one, one, one, one, one, one, one, [True]),
        # ServingEngine runs on its model's device; the CLI builds both
        "LM": lambda: LM(get_config("gemma2-9b", reduced=True)),
        "LM (hybrid)": lambda: LM(get_config("recurrentgemma-2b", reduced=True)),
        "LM (ssm)": lambda: LM(get_config("mamba2-780m", reduced=True)),
        "LM (vlm)": lambda: LM(get_config("llama-3.2-vision-11b", reduced=True)),
        "LM (encdec)": lambda: LM(get_config("whisper-base", reduced=True)),
        "ServingEngine (launch.serve)": lambda: serve.main(["--requests", "1"]),
        "ServingEngine (launch.serve, ssm)": lambda: serve.main(["--arch", "mamba2-780m", "--requests", "1"]),
        # the trainer runs on its model's device; the CLI builds it
        "launch.train": lambda: train.main(["--reduced", "--steps", "1"]),
    }


@pytest.mark.parametrize("entry", sorted(_default_device_calls()))
def test_default_device_is_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls()[entry]()


def test_cpu_is_asked_for_explicitly():
    from repro_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")


def _cm_args(J=3, S=2):
    f = lambda n: torch.ones(n, dtype=torch.float32)  # noqa: E731
    return [f(J), f(J), f(J), f(J), f(S), f(S), f(S), f(S), f(S), f(S), f(S),
            torch.ones(S, dtype=torch.bool)]


class TestWrapperValidation:
    """Wrappers reject what their kernel does not take, on any device."""

    def test_wrong_dtype(self):
        from repro_torch.kernels.cost_matrix.ops import cost_matrix_classed

        args = _cm_args()
        args[0] = args[0].double()
        with pytest.raises(TypeError, match="job_bytes must be torch.float32"):
            cost_matrix_classed(*args)

    def test_wrong_shape(self):
        from repro_torch.kernels.cost_matrix.ops import cost_matrix_classed

        args = _cm_args()
        args[5] = torch.ones(3, dtype=torch.float32)
        with pytest.raises(ValueError, match="queue has shape"):
            cost_matrix_classed(*args)

    def test_not_contiguous(self):
        from repro_torch.kernels.cost_matrix.ops import cost_matrix_f64

        rows = torch.ones((2, 8), dtype=torch.float64).t()
        args = (torch.ones(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64),
                torch.zeros(3, dtype=torch.int8), rows, torch.ones(2, dtype=torch.bool))
        with pytest.raises(ValueError, match="rows must be contiguous"):
            cost_matrix_f64(*args)

    def test_not_a_tensor(self):
        from repro_torch.kernels.priority_requeue.ops import priority_requeue

        n = torch.ones(4)
        with pytest.raises(TypeError, match="q must be a torch.Tensor"):
            priority_requeue(n, np.ones(4, np.float32), n, 1.0, 1.0)

    def test_unsupported_dtype(self):
        from repro_torch.kernels.priority_requeue.ops import priority_requeue

        n = torch.ones(4, dtype=torch.float16)
        with pytest.raises(TypeError, match="float32 or float64"):
            priority_requeue(n, n, n, 1.0, 1.0)

    def test_device_without_kernel_or_plain_version(self):
        from repro_torch.kernels.priority_requeue.ops import priority_requeue

        n = torch.ones(4, device="meta")
        with pytest.raises(ValueError, match="no kernel or plain version"):
            priority_requeue(n, n, n, 1.0, 1.0)


@pytest.mark.parametrize(
    "source,replaces",
    [
        ("kernels/cost_matrix/csrc/cost_matrix.cu", "src/repro/kernels/cost_matrix/cost_matrix.py"),
        ("kernels/priority_requeue/csrc/priority_requeue.cu",
         "src/repro/kernels/priority_requeue/priority_requeue.py"),
        ("kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py"),
        ("kernels/flash_attention/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention/flash_attention.py"),
        ("kernels/decode_attention/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py"),
    ],
)
def test_kernel_sources_are_built_and_name_their_tpu_kernel(source, replaces):
    from repro_torch.kernels import _build

    path = PORT / source
    assert path in _build.SOURCES
    text = path.read_text()
    assert replaces in text
    assert "Bound on an H100" in text
    assert "-fmad=false" in " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
