from .metrics import METRICS, Metrics  # noqa: F401
