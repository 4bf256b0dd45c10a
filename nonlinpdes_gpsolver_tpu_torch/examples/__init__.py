"""Command-line scripts of the four reference problems on the port.

Counterparts of the JAX package's ``examples/{elliptic,burgers,eikonal,darcy}.py``
with the same flags, less ``--platform``; ``--device`` (default ``cuda``) and
``--x64/--no-x64`` pick where and in which dtype they run, and ``--mesh P``
(with ``--mesh_block``) solves on the mesh path over P ranks, one card each,
under ``torchrun``::

    python -m nonlinpdes_gpsolver_tpu_torch.examples.darcy --device cpu --mesh 1
    torchrun --nproc_per_node 2 -m nonlinpdes_gpsolver_tpu_torch.examples.elliptic --mesh 2
"""
