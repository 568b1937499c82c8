"""KMeans view grouping shared by loaders and dataset prep."""

from __future__ import annotations

import numpy as np


def kmeans_view_groups(positions: np.ndarray, n: int, seed: int = 20211202):
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=n, n_init=10, random_state=seed).fit(positions)
    return [np.where(km.labels_ == i)[0] for i in range(n)]
