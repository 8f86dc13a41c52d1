"""Sufficient statistics for the closed-form supervised HSMM fit and
the framewise Gaussian mixture.

Host-side numpy (init-time only): per-class feature means, a tied
diagonal covariance equal to the biased per-dimension variance of all
frames (+ reg), the per-class diagonal, per-class full or tied full
covariances on request, and span start / transition / count / length
tallies. These are sklearn GaussianMixture's hard-assignment moments.
"""

import numpy as np

from action_segmentation_torch.ops.span_codec import labels_to_spans_np, rle_spans

REG_COVAR = 1e-6


def semimarkov_sufficient_stats(feature_list, label_list, n_classes, max_k=None,
                                covariance_type="tied_diag"):
    """Tally span statistics and Gaussian moments over a labeled corpus.

    feature_list: list of (T_i, D) float arrays
    label_list:   list of (T_i,) int arrays
    Returns a dict with keys:
      span_counts (C,), span_lengths (C,), span_start_counts (C,),
      span_transition_counts (C, C) [to, from], instance_count,
      gaussian_means (C, D), gaussian_cov (D,) tied diagonal,
      gaussian_cov_diag (C, D) per-class diagonal;
      with covariance_type 'full': gaussian_cov_full (C, D, D);
      with covariance_type 'tied': gaussian_cov_tied (D, D).
    The full-matrix moments cost O(T * D^2) host flops (float64), so
    they are accumulated only when asked for.
    """
    assert len(feature_list) == len(label_list)
    D = feature_list[0].shape[1]
    want_full = covariance_type == "full"
    want_tied = covariance_type == "tied"
    outer_sums = {}  # class -> (D, D) float64, for the classes with frames
    all_outer = np.zeros((D, D), np.float64) if want_tied else None
    span_counts = np.zeros(n_classes, np.float32)
    span_lengths = np.zeros(n_classes, np.float32)
    span_start_counts = np.zeros(n_classes, np.float32)
    span_transition_counts = np.zeros((n_classes, n_classes), np.float32)

    feat_sums = np.zeros((n_classes, D), np.float64)
    feat_sq_sums = np.zeros((n_classes, D), np.float64)
    frame_counts = np.zeros(n_classes, np.float64)

    all_sum = np.zeros(D, np.float64)
    all_sq_sum = np.zeros(D, np.float64)
    n_frames = 0

    for X, labels in zip(feature_list, label_list):
        X = np.asarray(X)
        labels = np.asarray(labels)
        np.add.at(feat_sums, labels, X)
        np.add.at(feat_sq_sums, labels, X**2)
        np.add.at(frame_counts, labels, 1.0)
        all_sum += X.sum(axis=0)
        all_sq_sum += (X**2).sum(axis=0)
        n_frames += X.shape[0]
        if want_full:
            for c in np.unique(labels):
                Xc = X[labels == c]
                outer_sums.setdefault(c, np.zeros((D, D), np.float64))
                outer_sums[c] += Xc.T @ Xc
        if want_tied:
            all_outer += X.T @ X

        spans = labels_to_spans_np(labels[None, :], max_k)
        rle = rle_spans(spans, np.array([spans.shape[1]]))[0]
        last_symbol = None
        for index, (symbol, length) in enumerate(rle):
            if index == 0:
                span_start_counts[symbol] += 1
            span_counts[symbol] += 1
            span_lengths[symbol] += length
            if last_symbol is not None:
                span_transition_counts[symbol, last_symbol] += 1
            last_symbol = symbol

    # class-conditional means (sklearn's nk includes a 10*eps guard so
    # empty classes yield ~0 means rather than NaN)
    nk = frame_counts + 10 * np.finfo(np.float64).eps
    means = (feat_sums / nk[:, None]).astype(np.float32)
    # tied diagonal covariance: biased variance of ALL frames + reg
    mean_all = all_sum / n_frames
    var_all = all_sq_sum / n_frames - mean_all**2
    cov = (var_all + REG_COVAR).astype(np.float32)
    mu = feat_sums / nk[:, None]
    cov_diag = (feat_sq_sums / nk[:, None] - mu**2 + REG_COVAR).astype(np.float32)

    extra = {}
    if want_full:
        # sklearn's _estimate_gaussian_covariances_full, one-hot resp:
        # sum_i r_ik (x_i - mu_k)(x_i - mu_k)^T / nk + reg * I; a class
        # with no frames has sums and mean 0, so reg * I exactly
        cov_full = np.empty((n_classes, D, D), np.float32)
        cov_full[:] = (REG_COVAR * np.eye(D)).astype(np.float32)
        for c, outer in outer_sums.items():
            cov_c = outer / nk[c] - mu[c][:, None] * mu[c][None, :] + REG_COVAR * np.eye(D)
            cov_full[c] = cov_c.astype(np.float32)
        extra["gaussian_cov_full"] = cov_full
    if want_tied:
        # sklearn's _estimate_gaussian_covariances_tied:
        # (X^T X - sum_k nk mu_k mu_k^T) / n + reg * I
        cov_tied = (all_outer - (nk[:, None] * mu).T @ mu) / nk.sum()
        extra["gaussian_cov_tied"] = (cov_tied + REG_COVAR * np.eye(D)).astype(np.float32)

    return {
        **extra,
        "span_counts": span_counts,
        "span_lengths": span_lengths,
        "span_start_counts": span_start_counts,
        "span_transition_counts": span_transition_counts,
        "instance_count": len(feature_list),
        "gaussian_means": means,
        "gaussian_cov": cov,
        "gaussian_cov_diag": cov_diag,
    }
