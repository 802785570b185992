"""The train step (``steps``) and the trainer (``train``:
``python -m repro_torch.launch.train``), the JAX package's ``repro.launch``
without its XLA-bound parts (shardings, lowering, the dry run)."""
