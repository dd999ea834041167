from . import avi, lemke, linalg  # noqa: F401
