"""A watch on the program's reads of tensors into the host: each read that
does not go through ``METRICS.sync`` (``qpn_tpu_torch/utils/metrics.py``),
the one counted read of the ensemble routes.  Shared by the CPU tests of
the shared-matrix route and its card test; imports no JAX."""

import torch

from qpn_tpu_torch.utils.metrics import METRICS

# the Tensor methods that read a tensor's values into the host: on the card
# each waits for it
READS = ("__bool__", "__int__", "__float__", "__index__", "__array__", "item",
         "tolist", "cpu")


def uncounted_reads(monkeypatch):
    """Record each read of a tensor's values into the host (``READS``) made
    outside ``METRICS.sync``: the list it returns fills as the program
    runs.  Read the counters outside the watched calls: reading them folds
    the device-side sums, itself a read."""
    depth, stray = [0], []
    real_sync = METRICS.sync

    def sync(read, *args):
        depth[0] += 1
        try:
            return real_sync(read, *args)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(METRICS, "sync", sync)
    for name in READS:
        def watched(self, *a, _real=getattr(torch.Tensor, name), _name=name,
                    **kw):
            if depth[0] == 0:
                stray.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, watched)
    return stray
