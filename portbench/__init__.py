"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` is its command; ``BENCHMARK.json`` at the root names its
cells, configurations, traffic mixes and metrics, each of which sits in
files of its own here (``cells``). Nothing here imports JAX or the JAX
package, and the plain reference (``reference``, ``queue_ref``) imports
nothing of the port.
"""
