"""The port's parallel layer: the level-pipeline sweep of chain networks
(``sharded.py``), the lockstep broker of scenario ensembles
(``lockstep.py``) and the process pool of spawned workers (``procpool.py``).
The ``torch.distributed`` half of ``qpn_tpu/parallel/`` is ROADMAP M5."""
