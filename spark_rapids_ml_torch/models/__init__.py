from . import classification, clustering, feature, knn, regression  # noqa: F401
