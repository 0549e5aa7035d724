"""The port's host math gives the same numbers on its first call in a
process as on every later one (ROADMAP.md C3).

The first vectorized ``torch.tanh``/``torch.exp`` that an intra-op thread
runs in a process can be off by about 5e-5 relative over that thread's
share of the tensor. ``repro_torch.warm_host_math`` absorbs it; this test
spawns a fresh interpreter that imports the port and nothing that warms
the math, which forks many children in turn. Each child calls the port's
``softcap`` and ``mlp`` twice on the same input and reports whether the
two calls agree bit for bit.

A child is a fresh process as far as torch's math is concerned (the
parent never ran a parallel transcendental), and forking skips the
interpreter's start-up, so many children fit in a few seconds. Without
the warm-up about one child in twenty-five came out off on an 8-core
AVX-512 host, so 192 children all pass only with a repaired port (a
chance of about 4e-4 otherwise).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = 192

_PROGRAM = r"""
import json, os, sys
import torch
from repro_torch.models.layers import mlp, softcap

def child():
    x = torch.linspace(-4.0, 4.0, 1 << 18)
    params = {k: torch.ones(1, 1) for k in ("w_gate", "w_up", "w_down")}
    a, b = softcap(x, 4.0), softcap(x, 4.0)
    g1, g2 = mlp(params, x[:, None], "geglu"), mlp(params, x[:, None], "geglu")
    return [int((a != b).sum()), int((g1 != g2).sum())]

out = []
for _ in range(int(sys.argv[1])):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            os.write(w, json.dumps(child()).encode())
        finally:
            os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        out.append(json.loads(f.read()))
    os.waitpid(pid, 0)
print(json.dumps(out))
"""


def test_first_call_equals_second_in_fresh_processes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("OMP_NUM_THREADS", None)
    r = subprocess.run(
        [sys.executable, "-c", _PROGRAM, str(CHILDREN)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    counts = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(counts) == CHILDREN
    off = [i for i, c in enumerate(counts) if c != [0, 0]]
    assert not off, f"first call differed from the second in children {off}: {[counts[i] for i in off]}"
