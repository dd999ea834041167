"""The port's parallel layer: the lockstep broker of scenario ensembles
(``lockstep.py``), the process pool of spawned workers (``procpool.py``),
and the multi-device layer on ``torch.distributed``: the ranks as a mesh
(``mesh.py``), process-group start-up (``multihost.py``), spawned ranks on
one machine (``launch.py``), the sharded superstep, prunes and level sweep
(``sharded.py``) and the ring-rotated prunes (``ring.py``)."""
