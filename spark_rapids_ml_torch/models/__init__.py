from . import knn  # noqa: F401
