"""The pod-compressed training step (``compress_pod_grads`` across a pod
axis) on 8 gloo ranks (2 × 2 × 2), against a naive JAX twin of the
reference's arithmetic.

The reference's own compressed step (``repro.runtime.train``'s
``per_pod`` body under a semi-manual ``shard_map``) aborts in XLA's
partitioner (ROADMAP C11), so the twin is written out here: per pod, one
unsharded ``jax.value_and_grad(LM.loss)`` on the pod's rows, split into
the reference's microbatches (accumulated in float32 and averaged), then
each leaf synced as ``src/repro/runtime/train.py:108-114`` does
(``repro.optim.quantize_int8`` of the leaf in float32, the codes summed
in int32 over the pods, the scales summed, summed·(scale_sum/n)/n in
the leaf's type), the losses averaged, then ``clip_by_global_norm``,
``linear_warmup_cosine`` and AdamW or adamw8.

* The sync alone (``runtime.train._int8_pod_sum``), float32, fed each
  pod's whole gradients cut into the ranks' blocks: bit for bit the
  twin's, every rank.
* Reduced gemma2-9b (AdamW, 2 microbatches, labels masked unevenly by
  row) and reduced deepseek-v2-236b (adamw8, the gather dispatch), 2
  steps: loss and grad norm within 1e-5 relative of the twin's, the
  learning rate equal; each rank's parameter blocks within
  ``assert_within_change``'s limits of the twin's, but where one of the
  twin's int8 codes of that element lay within 1e-3 of a half at some pod
  and step: the gradient's x/scale, and for adamw8 the moments' m and √v
  over their block's scale (a code there may differ by one: the gradients
  agree to float rounding, not bit for bit). Those must be under 10% of a
  leaf's elements (``NEAR_SHARE``).
* Reduced gemma2-9b with every label kept, one step with and one without
  compression: the losses equal within 1e-6 relative (every pod counts as
  many labels), and the grad norms within the quantization bound. The
  reference's sum dequantizes every pod's codes with the mean scale s̄, so
  an element of the synced gradient lies within (1/n)·Σ_p (s_p/2 +
  127·|s̄ − s_p|) of the pods' mean gradient; the norms differ by at most
  the root of Σ over the leaves of their size times that bound squared.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from repro.optim.adamw8 import _dequantize, adamw8_init, adamw8_update, block_size
from repro.optim.compress import quantize_int8
from repro_torch.models import params_from_reference

import _torch_pod_compress_ranks as pranks
import _torch_sharded_train_ranks as ranks

POD = {"pod": 2, "data": 2, "model": 2}
F32 = dict(param_dtype="float32", compute_dtype="float32")
SYNC = {"w": ([64, 48], ["data", "model"]), "stack": ([8, 6, 16], ["model", None, "data"]),
        "bias": ([40], [None]), "zero": ([4, 4], [None, None]), "halves": ([32, 32], ["data", None])}
CASES = {
    "sync": dict(kind="sync", specs={n: s for n, (_, s) in SYNC.items()}),
    "gemma2": dict(kind="train", arch="gemma2-9b", over=dict(F32, remat=False, local_window=8), B=8, S=32, steps=2,
                   tcfg=dict(ranks.TCFG, microbatches=2, optimizer="adamw"), seed=11, compress=[True]),
    "deepseek": dict(kind="train", arch="deepseek-v2-236b", over=F32, B=8, S=32, steps=2,
                     tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw8"), seed=12, compress=[True]),
    "plain": dict(kind="train", arch="gemma2-9b", over=dict(F32, remat=False, local_window=8), B=8, S=32, steps=1,
                  tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw"), seed=13, compress=[True, False],
                  unmasked=True),
}
TRAIN = ["gemma2", "deepseek"]
LOSS_RTOL = 1e-5
HALF_BAND = 1e-3
# The elements left out for a code at a half, at most this share of a leaf's: about 2·HALF_BAND a
# pod and step for the gradient's codes; the synced gradient lies on a lattice of the mean scale, so
# adamw8's moment codes land on exact halves more often (measured: at most 7.9%, deepseek's unembed).
NEAR_SHARE = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _inputs() -> dict:
    rng = np.random.default_rng(5)
    inp = {}
    for n, (shape, _) in SYNC.items():
        for p in range(POD["pod"]):
            g = rng.standard_normal(shape).astype(np.float32) * (0.5 + p)
            if n == "zero":
                g[:] = 0
            if n == "halves":          # x/scale exactly at halves: round half to even decides
                g = (rng.integers(-120, 120, shape) + 0.5).astype(np.float32)
                g.flat[0] = 127.0
            inp[f"sync/pod{p}/{n}"] = g
    for key, c in CASES.items():
        if c["kind"] != "train":
            continue
        cfg = ranks.config(dict(c, mesh=POD))
        inp |= {f"{key}/params/{k}": v for k, v in ranks.reference_tree(cfg, c["seed"]).items()}
        for s, b in enumerate(ranks.batches(cfg, c["B"], c["S"], c["steps"], c["seed"])):
            if c.get("unmasked"):
                b["labels"] = np.random.default_rng(c["seed"] + s).integers(0, cfg.vocab_size, b["labels"].shape,
                                                                             dtype=np.int32)
            inp |= {f"{key}/{n}{s}": a for n, a in b.items()}
    return inp


def _sync_twin(per_pod: list, n: int):
    """The reference's ``sync`` of one leaf over the pods' gradients:
    (the synced gradient, each pod's scale, each pod's x/scale)."""
    qs, scales, ratios = [], [], []
    for g in per_pod:
        x = jnp.asarray(g).astype(jnp.float32)
        q, scale = quantize_int8(x)
        qs.append(q.astype(jnp.int32))
        scales.append(scale)
        ratios.append(np.asarray(x / scale))
    summed, scale_sum = sum(qs), sum(scales)
    out = (summed.astype(jnp.float32) * (scale_sum / n) / n).astype(jnp.asarray(per_pod[0]).dtype)
    return np.asarray(out), [float(s) for s in scales], ratios


def _moment_halves(grads, opt, params) -> list:
    """adamw8's moment codes at this update (``repro.optim.adamw8``): per
    parameter leaf, the elements whose m or √v over its block's scale lies
    within HALF_BAND of a half (the next step reads those codes)."""
    cfg = AdamWConfig()
    is_q = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
    out = []
    for g, mq, vq, p in zip(jax.tree.leaves(grads), jax.tree.leaves(opt["m"], is_leaf=is_q),
                            jax.tree.leaves(opt["v"], is_leaf=is_q), jax.tree.leaves(params)):
        shape = p.shape if p.ndim else (1,)
        g32 = g.astype(jnp.float32).reshape(shape)
        m = cfg.b1 * _dequantize(mq, shape) + (1 - cfg.b1) * g32
        v = cfg.b2 * jnp.square(_dequantize(vq, shape)) + (1 - cfg.b2) * jnp.square(g32)
        close = jnp.zeros(shape, bool)
        for x in (m, jnp.sqrt(v)):
            b = block_size(shape[-1])
            xb = x.reshape(shape[:-1] + (shape[-1] // b, b))
            scale = jnp.maximum(jnp.max(jnp.abs(xb), axis=-1), 1e-12) / 127.0
            r = jnp.abs(xb / scale[..., None])
            close = close | (jnp.abs(r - jnp.floor(r) - 0.5) < HALF_BAND).reshape(shape)
        out.append(close.reshape(p.shape))
    return out


def _twin(key: str, inp: dict) -> dict:
    """The naive twin's run of a training case: each step's metrics, the
    parameters before and after, each step's pods' per-leaf scales, and a
    mask of the elements whose x/scale lay within HALF_BAND of a half at
    some pod and step. The per-pod gradients and the sync, clip, schedule
    and update are each one jitted function."""
    c = CASES[key]
    cfg = ref_get_config(c["arch"], reduced=True).replace(**c["over"])
    lm = RefLM(cfg)
    tc, P, n = c["tcfg"], POD["pod"], c["tcfg"]["microbatches"]
    params = jax.tree.map(jnp.asarray, ranks.tree_of(inp, f"{key}/params/"))
    opt = (adamw8_init if tc["optimizer"] == "adamw8" else adamw_init)(params)
    update = adamw8_update if tc["optimizer"] == "adamw8" else adamw_update
    vg = jax.value_and_grad(lambda p, b: lm.loss(p, b), has_aux=True)

    @jax.jit
    def pod_grads(params, rows):
        """One pod's gradient and loss: the reference's ``grads_of``."""
        if n == 1:
            (loss, _), g = vg(params, rows)
            return g, loss
        gsum = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), params)
        lsum = jnp.zeros((), jnp.float32)
        for i in range(n):
            (loss_i, _), g_i = vg(params, jax.tree.map(lambda v: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i],
                                                       rows))
            gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), gsum, g_i)
            lsum = lsum + loss_i
        return jax.tree.map(lambda x: x * (1.0 / n), gsum), lsum * (1.0 / n)

    @jax.jit
    def post(grads, losses, params, opt):
        """The sync of every leaf over the pods (``train.py:108-114``), the
        loss's mean, the clip, the schedule and the update."""
        per_pod = [jax.tree.leaves(g) for g in grads]
        synced, scales, near = [], [], []
        for i in range(len(per_pod[0])):
            qs, sc, close = [], [], jnp.zeros(per_pod[0][i].shape, bool)
            for p in range(P):
                x = per_pod[p][i].astype(jnp.float32)
                q, scale = quantize_int8(x)
                qs.append(q.astype(jnp.int32))
                sc.append(scale)
                r = jnp.abs(x / scale)
                close = close | (jnp.abs(r - jnp.floor(r) - 0.5) < HALF_BAND)
            synced.append((sum(qs).astype(jnp.float32) * (sum(sc) / P) / P).astype(per_pod[0][i].dtype))
            scales.append(jnp.stack(sc))
            near.append(close)
        g = jax.tree.unflatten(jax.tree.structure(grads[0]), synced)
        g, gnorm = clip_by_global_norm(g, 1.0)
        lr = linear_warmup_cosine(opt["step"], tc["warmup_steps"], tc["total_steps"], tc["peak_lr"])
        if tc["optimizer"] == "adamw8":
            near = [a | b for a, b in zip(near, _moment_halves(g, opt, params))]
        params, opt = update(g, opt, params, lr, AdamWConfig())
        return params, opt, sum(losses) / P, gnorm, lr, scales, near

    leaves0, treedef = jax.tree.flatten(params)
    near = [np.zeros(x.shape, bool) for x in leaves0]
    metrics, scales = [], []
    Bp = c["B"] // P
    for s in range(c["steps"]):
        batch = ranks.batch_of(inp, key, s)
        grads, losses = zip(*(pod_grads(params, {k: jnp.asarray(v[p * Bp:(p + 1) * Bp]) for k, v in batch.items()})
                              for p in range(P)))
        params, opt, loss, gnorm, lr, sc, close = post(list(grads), list(losses), params, opt)
        near = [a | np.asarray(b) for a, b in zip(near, close)]
        scales.append([[float(v) for v in np.asarray(x)] for x in sc])
        metrics.append([float(loss), float(gnorm), float(lr)])
    pcfg = ranks.config(dict(c, mesh=POD))
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"metrics": np.asarray(metrics), "before": params_from_reference(pcfg, ranks.tree_of(inp, f"{key}/params/")),
            "after": params_from_reference(pcfg, as_np(params)), "scales": scales,
            "near": params_from_reference(pcfg, jax.tree.unflatten(treedef, [m.astype(np.float32) for m in near])),
            "sizes": [int(np.prod(x.shape)) for x in leaves0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the inputs, each training case's twin): the
    ranks run while the twins are computed."""
    import threading

    from repro_torch.launch.mesh import run_ranks

    work = tmp_path_factory.mktemp("pod_compress")
    inp = _inputs()
    (work / "cases.json").write_text(json.dumps(CASES))
    np.savez(work / "inputs.npz", **inp)
    got: dict = {}
    errors: list = []

    def spawn():
        try:
            got["ranks"] = run_ranks(pranks.run, POD, backend="gloo", device_type="cpu", args=(str(work),),
                                     timeout=600)
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    try:
        twins = {k: _twin(k, inp) for k, c in CASES.items() if c["kind"] == "train"}
    finally:
        t.join()
    if errors:
        raise errors[0]
    return got["ranks"], inp, twins


def _coords(r) -> dict:
    return dict(zip(POD, (int(c) for c in r["coords"])))


@pytest.mark.parametrize("leaf", list(SYNC))
def test_the_int8_pod_sum_is_the_reference_arithmetic_bit_for_bit(runs, leaf):
    port, inp, _ = runs
    want, _, _ = _sync_twin([inp[f"sync/pod{p}/{leaf}"] for p in range(POD["pod"])], POD["pod"])
    spec = pranks.spec_of(SYNC[leaf][1])
    for r in port:
        got = r[f"sync/{leaf}"]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ranks.cut(want, spec, POD, _coords(r)), err_msg=f"{leaf} {_coords(r)}")
    if leaf == "zero":
        assert not want.any()


@pytest.mark.parametrize("key", TRAIN)
def test_compressed_step_metrics_equal_the_twin(runs, key):
    port, _, twins = runs
    want = twins[key]["metrics"]
    assert want[0, 2] == 0.0 and want[1, 2] > 0
    for r in port:
        got = r[f"{key}/compressed/metrics"]
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=LOSS_RTOL, atol=0, err_msg=f"{key} {_coords(r)}")
        np.testing.assert_array_equal(got[:, 2].astype(np.float32), want[:, 2].astype(np.float32))


@pytest.mark.parametrize("key", TRAIN)
def test_compressed_step_parameter_blocks_equal_the_twin(runs, key):
    port, _, twins = runs
    tw, opt = twins[key], CASES[key]["tcfg"]["optimizer"]
    for r in port:
        coords = _coords(r)
        specs = json.loads(str(r[f"{key}/compressed/specs"]))
        for name, spec in specs.items():
            change = float((tw["after"][name] - tw["before"][name]).abs().max())
            assert change > 0, name
            near = ranks.cut(tw["near"][name].numpy(), spec, POD, coords) > 0.5
            assert near.mean() < NEAR_SHARE, (name, near.mean())
            got = r[f"{key}/compressed/params/{name}"][~near]
            want = ranks.cut(tw["after"][name].numpy(), spec, POD, coords)[~near]
            ranks.assert_within_change(got, want, change, opt, f"{key} {name} at {coords}")


def test_compressed_and_uncompressed_steps_agree_within_the_quantization_bound(runs):
    port, _, twins = runs
    tw = twins["plain"]
    P = POD["pod"]
    bound_sq = 0.0
    for size, sc in zip(tw["sizes"], tw["scales"][0]):
        mean = sum(sc) / P
        bound_sq += size * (sum(s / 2 + 127 * abs(mean - s) for s in sc) / P) ** 2
    bound = float(np.sqrt(bound_sq))
    for r in port:
        comp, plain = r["plain/compressed/metrics"][0], r["plain/plain/metrics"][0]
        assert comp[0] == pytest.approx(plain[0], rel=1e-6)
        assert abs(comp[1] - plain[1]) <= bound + LOSS_RTOL * plain[1], (comp[1], plain[1], bound)
    np.testing.assert_allclose(port[0]["plain/compressed/metrics"][:, :2], tw["metrics"][:, :2], rtol=LOSS_RTOL)
