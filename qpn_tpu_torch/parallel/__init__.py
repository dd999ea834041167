"""The port's parallel layer.  So far only the level-pipeline sweep of chain
networks (``sharded.py``); the multi-device layer of ``qpn_tpu/parallel/`` is
ROADMAP slice 4."""
