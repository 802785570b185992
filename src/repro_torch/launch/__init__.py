"""Cell programs (``steps``: the train step, ``CellProgram`` and
``build_*_program`` on DTensor placements), meshes of H100s (``mesh``), the
trainer (``train``: ``python -m repro_torch.launch.train``) and the dry run
of every cell on the production meshes (``dryrun``: ``python -m
repro_torch.launch.dryrun``), the JAX package's ``repro.launch``."""
