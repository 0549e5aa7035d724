"""The port's sharding rules (``repro_torch.runtime.sharding``/``pspec``,
``launch.mesh``) against the reference's, on the CPU.

The reference's meshes are built as ``tests/substrate/test_sharding_hlo.py``
builds them: one host device repeated over the mesh's shape. The port's
meshes are axis → size mappings. Every port parameter's spec equals the
reference leaf's spec with the stacked layer axes dropped, for every
architecture at full width, at meshes (2, 2), (16, 16), (2, 16, 16) and
(1, 4), training and serving; the batch and cache specs over
``input_specs`` and ``abstract_cache``; ``spec_for`` on the reference's
``TestPspec`` cases and a sweep of shapes and logical axes."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import input_specs as ref_input_specs
from repro.models import LM as RefLM
from repro.runtime import pspec as rps, sharding as rsh
from repro.runtime.serve import abstract_cache as ref_abstract_cache
from repro.runtime.train import abstract_train_state as ref_abstract_train_state
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import input_specs
from repro_torch.launch.mesh import make_production_mesh, mesh_from_arg
from repro_torch.models import LM
from repro_torch.optim.adamw import stack_position
from repro_torch.runtime import pspec as pps, sharding as psh
from repro_torch.runtime.serve import abstract_cache
from repro_torch.runtime.train import init_opt_state

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, settings, strategies as st


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


MESHES = {"2x2": ((2, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")), "1x4": ((1, 4), ("data", "model"))}


def _ref_mesh(shape, axes):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


def _meshes(key):
    shape, axes = MESHES[key]
    return _ref_mesh(shape, axes), dict(zip(axes, shape))


@functools.cache
def _ref_params(arch):
    return RefLM(ref_get_config(arch)).abstract_params()


@functools.cache
def _port_lm(arch):
    return LM(get_config(arch), device="meta")


def _ref_leaf(tree, name):
    """(the reference leaf a port parameter slices, its stacked axes)."""
    pos = stack_position(name)
    path, n = (pos[0], len(pos[1])) if pos else (tuple(name.split(".")), 0)
    for k in path:
        tree = tree[k]
    return tree, n


def _drop(spec, n):
    return tuple(spec)[n:]


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference_leaf_specs(arch, mesh_key):
    ref_mesh, mesh = _meshes(mesh_key)
    ref_params, lm = _ref_params(arch), _port_lm(arch)
    params = dict(lm.named_parameters())
    for serve in (False, True):
        want = rsh.param_specs(ref_mesh, ref_params, serve=serve)
        got = psh.param_specs(mesh, lm, serve=serve)
        assert psh.needs_zero3(mesh, lm, serve=serve) == rsh.needs_zero3(ref_mesh, ref_params, serve=serve)
        assert got.keys() == params.keys()
        for name, spec in got.items():
            leaf, n = _ref_leaf(want, name)
            ref_leaf, _ = _ref_leaf(ref_params, name)
            assert tuple(ref_leaf.shape[n:]) == tuple(params[name].shape), name
            assert spec == _drop(leaf, n), (name, serve, spec, leaf)


@pytest.mark.parametrize("zero3", [True, False])
def test_param_specs_of_the_reference_unit_cases(zero3):
    """tests/substrate/test_sharding_hlo.py's leaves, one layer of each."""
    ref_mesh, mesh = _meshes("2x2")
    f = jax.ShapeDtypeStruct
    ref = {"blocks": {"attn": {"wq": f((4, 64, 8, 32), np.float32), "wo": f((4, 8, 32, 64), np.float32)},
                      "mlp": {"w_gate": f((4, 64, 256), np.float32), "w_down": f((4, 256, 64), np.float32)}},
           "moe_blocks": {"moe": {"w_gate": f((8, 16, 64, 128), np.float32)}},
           "embed": f((512, 64), np.float32), "final_norm": f((64,), np.float32)}
    port = {"blocks.2.attn.wq": (64, 8, 32), "blocks.2.attn.wo": (8, 32, 64), "blocks.0.mlp.w_gate": (64, 256),
            "blocks.3.mlp.w_down": (256, 64), "moe_blocks.5.moe.w_gate": (16, 64, 128), "embed": (512, 64),
            "final_norm": (64,)}
    want = rsh.param_specs(ref_mesh, ref, zero3=zero3)
    got = psh.param_specs(mesh, port, zero3=zero3)
    for name, spec in got.items():
        leaf, n = _ref_leaf(want, name)
        assert spec == _drop(leaf, n), name
    if zero3:
        assert got["blocks.2.attn.wq"] == ("data", "model", None)
        assert got["moe_blocks.5.moe.w_gate"] == (("model", "data"), None, None)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-236b", "llama-3.2-vision-11b", "mamba2-780m"])
def test_opt_specs_follow_the_param_specs(arch, mesh_key):
    """AdamW's moments take the parameters' specs; adamw8's codes and scales
    the reference's rule (the last axis rides on the block count), for every
    parameter of at least one dimension (a 0-d parameter a layer is one
    stacked leaf in the reference: ``optim.adamw8.stacked_scalars``)."""
    ref_mesh, mesh = _meshes(mesh_key)
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, device="meta")
    ref_params, ref_opt = ref_abstract_train_state(RefLM(ref_get_config(arch, reduced=True)), optimizer="adamw8")
    rspecs = rsh.param_specs(ref_mesh, ref_params)
    want = rsh.opt8_specs(ref_mesh, ref_opt, rspecs)
    pspecs = psh.param_specs(mesh, lm)
    assert psh.opt_specs(mesh, init_opt_state(lm), pspecs) == {"m": pspecs, "v": pspecs, "step": ()}
    got = psh.opt8_specs(mesh, init_opt_state(lm, "adamw8"), pspecs)
    for name, p in lm.named_parameters():
        if p.dim() == 0:
            continue
        for mom in ("m", "v"):
            leaf, n = _ref_leaf(want[mom], name)
            assert got[mom][name]["q"] == _drop(leaf["q"], n), (name, mom)
            assert got[mom][name]["scale"] == _drop(leaf["scale"], n), (name, mom)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_equal_the_reference(arch, shape, mesh_key):
    ref_mesh, mesh = _meshes(mesh_key)
    for pod_manual in (False, True):
        want = rsh.batch_specs(ref_mesh, ref_input_specs(ref_get_config(arch), shape), pod_manual=pod_manual)
        got = psh.batch_specs(mesh, input_specs(get_config(arch), shape), pod_manual=pod_manual)
        assert got == {k: tuple(v) for k, v in want.items()}


def _spec_tree(tree):
    return {k: _spec_tree(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch, mesh_key):
    ref_mesh, mesh = _meshes(mesh_key)
    for batch, max_len in ((1, 64), (32, 1024)):
        want = rsh.cache_specs(ref_mesh, ref_abstract_cache(RefLM(ref_get_config(arch, reduced=True)), batch,
                                                            max_len), batch)
        got = psh.cache_specs(mesh, abstract_cache(LM(get_config(arch, reduced=True), device="meta"), batch,
                                                   max_len), batch)
        assert got == _spec_tree(want)


def test_the_reference_cache_and_batch_unit_cases():
    ref_mesh, mesh = _meshes("2x2")
    k = torch.empty((8, 16, 1024, 8, 32), device="meta")
    assert psh.cache_specs(mesh, {"k": k}, batch_size=16) == {"k": (None, "data", "model", None, None)}
    k1 = torch.empty((8, 1, 1024, 8, 32), device="meta")
    assert psh.cache_specs(mesh, {"k": k1}, batch_size=1) == {"k": (None, None, "model", None, None)}
    tok = torch.empty((8, 128), dtype=torch.int32, device="meta")
    assert psh.batch_specs({"pod": 2, "data": 2, "model": 2}, {"tokens": tok}) == {"tokens": (("pod", "data"), None)}


# -- pspec ----------------------------------------------------------------------

def test_shard_is_a_no_op():
    x = torch.ones((4, 4))
    assert pps.shard(x, "batch", None) is x
    with pps.logical_axis_rules({"data": 2, "model": 2}):
        assert pps.shard(x, "batch", None) is x
        assert pps.current_mesh() == {"data": 2, "model": 2}
    assert pps.current_mesh() is None


def test_spec_for_the_reference_case():
    ref_mesh, mesh = _meshes("2x2")
    with rps.logical_axis_rules(ref_mesh):
        want = rps.spec_for(ref_mesh, (4, 10, 8), ("batch", "heads", "ff"))
    with pps.logical_axis_rules(mesh):
        got = pps.spec_for(mesh, (4, 10, 8), ("batch", "heads", "ff"))
    assert got == tuple(want) == ("data", "model", None)


_LOGICAL = [None, *rps.DEFAULT_RULES]


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=60, deadline=None)
def test_spec_for_equals_the_reference_on_a_sweep(seed):
    rng = np.random.default_rng(seed)
    key = list(MESHES)[rng.integers(len(MESHES))]
    ref_mesh, mesh = _meshes(key)
    n = int(rng.integers(1, 5))
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 10, 16, 32, 48, 64, 512])) for _ in range(n))
    axes = tuple(_LOGICAL[i] for i in rng.integers(len(_LOGICAL), size=n))
    rules = {"heads": (("data",),)} if rng.integers(2) else None
    with rps.logical_axis_rules(ref_mesh, rules):
        want = rps.spec_for(ref_mesh, shape, axes)
    with pps.logical_axis_rules(mesh, rules):
        got = pps.spec_for(mesh, shape, axes)
    assert got == tuple(want), (key, shape, axes, rules)


# -- launch.mesh ------------------------------------------------------------------

@pytest.mark.parametrize("arg,want", [("single", {"data": 16, "model": 16}),
                                      ("multi", {"pod": 2, "data": 16, "model": 16}),
                                      ("2x4", {"data": 2, "model": 4}), ("2x2x2", {"pod": 2, "data": 2, "model": 2}),
                                      ("1", {"model": 1}), ("1x4", {"data": 1, "model": 4})])
def test_mesh_shapes(arg, want):
    got = mesh_from_arg(arg)
    assert got == want and list(got) == list(want)
    if arg in ("single", "multi"):
        assert make_production_mesh(multi_pod=arg == "multi") == want


@pytest.mark.parametrize("arg", ["0x4", "2x2x2x2", "x"])
def test_mesh_refuses_malformed_shapes(arg):
    with pytest.raises(ValueError):
        mesh_from_arg(arg)


def test_per_device_bytes():
    t = torch.empty((16, 4096, 8), dtype=torch.bfloat16, device="meta")
    mesh = {"pod": 2, "data": 4, "model": 8}
    assert psh.per_device_bytes(mesh, t, (("pod", "data"), "model", None)) == 2 * 512 * 8 * 2
    assert psh.per_device_bytes(mesh, t, (None, None, None)) == 16 * 4096 * 8 * 2
