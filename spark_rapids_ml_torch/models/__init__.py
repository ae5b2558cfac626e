from . import classification, feature, knn, regression  # noqa: F401
