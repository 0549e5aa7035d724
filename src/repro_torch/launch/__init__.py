"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``.train`` and ``.dryrun``), the mesh shapes
the dry run reports against (``mesh``) and its op-level analysis
(``op_analysis``, the twin of the reference's ``hlo_analysis``)."""
