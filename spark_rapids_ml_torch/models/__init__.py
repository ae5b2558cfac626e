from . import classification, knn  # noqa: F401
