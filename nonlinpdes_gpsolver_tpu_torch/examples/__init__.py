"""Command-line scripts of the four reference problems on the port.

Counterparts of the JAX package's ``examples/{elliptic,burgers,eikonal,darcy}.py``
with the same flags, less ``--platform`` and ``--mesh_block``; ``--device``
(default ``cuda``) and ``--x64/--no-x64`` pick where and in which dtype they
run, and a nonzero ``--mesh`` raises (the mesh path is not ported yet)::

    python -m nonlinpdes_gpsolver_tpu_torch.examples.darcy --device cpu
"""
