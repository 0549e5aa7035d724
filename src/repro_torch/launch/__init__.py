"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``.train`` and ``.dryrun``), the meshes
(``mesh``: the shapes the dry run reports against, and meshes placed over
a process group with their collectives) and the dry run's op-level analysis
(``op_analysis``, the twin of the reference's ``hlo_analysis``)."""
