"""Command-line scripts of the four reference problems on the port.

Counterparts of the JAX package's ``examples/{elliptic,burgers,eikonal,darcy}.py``
with the same flags, less ``--platform``; ``--device`` (default ``cuda``) and
``--x64/--no-x64`` pick where and in which dtype they run, and ``--mesh 1``
(with ``--mesh_block``) solves on the mesh path (a larger ``--mesh`` raises
``NotImplementedError``: several devices are slice 4)::

    python -m nonlinpdes_gpsolver_tpu_torch.examples.darcy --device cpu --mesh 1
"""
