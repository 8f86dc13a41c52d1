"""Grouped PCA feature preprocessing.

Twin of the JAX package's ``data/features.py`` (the reference's sklearn
pipeline, src/data/features.py:18-43): for each feature group the
centered data matrix of all videos is decomposed with
``torch.linalg.svd`` in float32 and the top-`n_components` right singular
vectors project each video. Components are sign-fixed the way sklearn >=
1.5 does (svd_flip with u_based_decision=False: flip each component so
its largest-|entry| coefficient in Vt is positive). Arrays go in and come
out as numpy; the SVD and the projection run on `device` (the card unless
the caller passes ``device="cpu"``).
"""

import numpy as np
import torch

from action_segmentation_torch import resolve_device
from action_segmentation_torch.utils import all_equal, logger


class PCAModel:
    """Fitted PCA projection: x -> (x - mean) @ components.T."""

    def __init__(self, mean, components, explained_variance_ratio, device=None):
        self.mean_ = np.asarray(mean)
        self.components_ = np.asarray(components)
        self.explained_variance_ratio_ = np.asarray(explained_variance_ratio)
        self.device = resolve_device(device)

    def transform(self, x):
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        out = (dev(x) - dev(self.mean_)) @ dev(self.components_).T
        return out.cpu().numpy()


def fit_pca(X, n_components, device=None):
    """Fit PCA on (N, D) data; returns PCAModel. The SVD runs in float32,
    as the JAX package's does (parity tests compare against sklearn with
    a loose tolerance)."""
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    n_components = min(n_components, X.shape[1], X.shape[0])
    mean = X.mean(axis=0)
    _, s, vt = torch.linalg.svd(torch.as_tensor(X - mean, device=device),
                                full_matrices=False)
    # sklearn svd_flip (u_based_decision=False): flip each component so its
    # largest-|entry| coefficient in Vt is positive
    max_cols = vt.abs().argmax(dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=device), max_cols])
    s = s.cpu().numpy()
    vt = (vt * signs[:, None]).cpu().numpy()
    explained = (s**2) / (X.shape[0] - 1)
    ratio = explained / explained.sum()
    return PCAModel(mean, vt[:n_components], ratio[:n_components], device)


def merge_grouped(grouped_features):
    """Concatenate per-group features per video (features.py:7-15)."""
    merged = {}
    assert all_equal(gd.keys() for gd in grouped_features.values())
    for vid_name in next(iter(grouped_features.values())):
        values = [
            t[1][vid_name]
            for t in sorted(grouped_features.items(), key=lambda t: t[0])
        ]
        merged[vid_name] = np.hstack(values)
    return merged


def grouped_pca(grouped_features, n_components, pca_models_by_group=None, device=None):
    """Fit per-group PCA over all videos and transform each video
    (features.py:18-43). Each group's videos are projected in one stacked
    product and split back by row counts."""
    if pca_models_by_group is not None:
        assert set(grouped_features.keys()) == set(pca_models_by_group.keys())
    else:
        pca_models_by_group = {}
        for group_name, vid_dict in grouped_features.items():
            assert all_equal(v.shape[1] for v in vid_dict.values())
            X = np.vstack(list(vid_dict.values()))
            pca = fit_pca(X, min(n_components, X.shape[1]), device)
            logger.debug("group {}: {} instances".format(group_name, len(vid_dict)))
            logger.debug(
                "group {}: pca explained {} of the variance".format(
                    group_name, pca.explained_variance_ratio_.sum()
                )
            )
            pca_models_by_group[group_name] = pca
    transformed = {}
    for group_name, vid_dict in grouped_features.items():
        names = list(vid_dict.keys())
        rows = np.cumsum([vid_dict[n].shape[0] for n in names])[:-1]
        stacked = pca_models_by_group[group_name].transform(
            np.vstack([vid_dict[n] for n in names])
        )
        transformed[group_name] = dict(zip(names, np.split(stacked, rows)))
    return transformed, pca_models_by_group
