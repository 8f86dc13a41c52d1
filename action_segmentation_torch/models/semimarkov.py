"""Hidden semi-Markov segmentation model, PyTorch.

Twin of ``action_segmentation_tpu/models/semimarkov.py`` for the decode
slice:

* ``GaussianHsmm`` is an ``nn.Module`` holding the Poisson log-rates,
  Gaussian means, tied diagonal covariance (a frozen buffer) and the
  transition/init logits; it builds batched ``HsmmPotentials`` for a
  set of valid classes, and fits itself in closed form;
* ``SemiMarkovModel`` batches a datasplit, fits it (closed form) and
  decodes it, streaming batches to the device with every label tensor
  kept there until one stacked copy at the end.

Decode goes through the two CUDA kernels of ``ops/hsmm_cuda.py`` for
C <= 128 and through the traceback ``hsmm_viterbi`` above that.
Gradient and unsupervised training, transition and end constraints,
narration, class merging, flows and the compound model raise
``NotImplementedError``: they come with later slices (ROADMAP.md §1).
"""

import numpy as np
import torch
from torch import nn

from action_segmentation_torch import BIG_NEG, resolve_device
from action_segmentation_torch.data.batching import iter_batches, pad_class_width
from action_segmentation_torch.models.base import Model
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from action_segmentation_torch.ops.hsmm import HsmmPotentials, hsmm_viterbi
from action_segmentation_torch.ops.hsmm_cuda import (
    MAX_CLASSES,
    hsmm_viterbi_labels,
    kernels_supported,
)
from action_segmentation_torch.ops.span_codec import spans_to_labels
from action_segmentation_torch.ops.stats import semimarkov_sufficient_stats
from action_segmentation_torch.utils import all_equal
from action_segmentation_torch.utils.drain import DeferredLabelDrain

_LATER = "is not ported yet; it comes with a later slice (ROADMAP.md §1)"

# flags of the JAX package's SemiMarkovModel whose paths are not ported;
# from_args refuses them rather than decode something else
_UNPORTED_FLAGS = (
    "sm_constrain_transitions",
    "sm_constrain_with_narration",
    "sm_component_model",
    "sm_feature_projection",
    "sm_init_non_projection_parameters_from",
)


def upload(x, device):
    """Host array -> tensor on `device`. CUDA copies go through pinned
    memory without blocking the host, so a decode loop never waits for
    the card between batches."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class GaussianHsmm(nn.Module):
    """Gaussian-emission HSMM parameterization.

    Parameters carry the JAX package's ``GaussianHsmm.params`` names, so
    a params dict from either side loads into the other
    (``bridge.gaussian_hsmm_params_from_numpy``)."""

    def __init__(self, args, n_classes, n_dims, allow_self_transitions=False,
                 seed=0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.args = args
        self.n_classes = n_classes
        self.feature_dim = n_dims
        self.allow_self_transitions = allow_self_transitions
        # --sm_hidden_markov fixes K=1 (degenerate HSMM -> HMM)
        self.max_k = (
            1 if getattr(args, "sm_hidden_markov", False) else args.sm_max_span_length
        )
        gen = torch.Generator().manual_seed(int(seed))
        f32 = dict(dtype=torch.float32, device=device)
        self.poisson_log_rates = nn.Parameter(torch.zeros(n_classes, **f32))
        self.gaussian_means = nn.Parameter(torch.zeros(n_classes, n_dims, **f32))
        # frozen: the covariance is set by moments, never by gradients
        self.register_buffer("gaussian_cov", torch.ones(n_dims, **f32))
        self.transition_logits = nn.Parameter(torch.zeros(n_classes, n_classes, **f32))
        self.init_logits = nn.Parameter(
            torch.rand(n_classes, generator=gen, dtype=torch.float32).to(device)
        )

    def compute_potentials(self, features, vc, constraints_add, end_allowed):
        """Batched HsmmPotentials for valid classes `vc` (C_sub,).

        features (B, T, D); constraints_add (B, T, C_sub) additive
        emission penalties; end_allowed (B, C_sub) additive end mask.

        vc entries of -1 are shape padding (class-count bucketing): their
        initial/transition rows are masked to BIG_NEG before every
        softmax, so they carry no probability mass and are never
        decoded; parameter gathers use a clipped index.
        """
        B = features.shape[0]
        pad = vc < 0
        vcs = vc.clamp(min=0)
        init = initial_log_probs(self.init_logits[vcs], pad)
        trans = transition_log_probs(
            self.transition_logits[vcs][:, vcs],
            pad[:, None] | pad[None, :],
            self.allow_self_transitions,
        )
        lens = poisson_length_log_probs(self.poisson_log_rates[vcs], self.max_k)
        emit = gaussian_emission_log_probs(
            features, self.gaussian_means[vcs], self.gaussian_cov
        )
        return HsmmPotentials(
            trans=trans.expand((B,) + trans.shape),
            init=init.expand((B,) + init.shape),
            lens=lens.expand((B,) + lens.shape),
            emit=emit + constraints_add,
            end_mask=end_allowed,
        )

    @torch.no_grad()
    def initialize_gaussian(self, feature_list):
        """Mean/variance moment init: every class gets the corpus mean,
        the covariance is the per-dimension sample variance."""
        feats = np.concatenate([np.asarray(f) for f in feature_list], axis=0)
        mean = torch.as_tensor(feats.mean(axis=0), dtype=torch.float32)
        var = torch.as_tensor(feats.var(axis=0, ddof=1), dtype=torch.float32)
        self.gaussian_means.copy_(mean.expand(self.n_classes, self.feature_dim))
        self.gaussian_cov.copy_(var)

    @torch.no_grad()
    def fit_supervised(self, feature_list, label_list):
        """Smoothed closed-form MLE from span and Gaussian moments."""
        stats = semimarkov_sufficient_stats(
            feature_list, label_list, n_classes=self.n_classes, max_k=self.max_k
        )
        ss = self.args.sm_supervised_state_smoothing
        ls = self.args.sm_supervised_length_smoothing

        init_probs = (stats["span_start_counts"] + ss) / float(
            stats["instance_count"] + ss * self.n_classes
        )
        init_probs[np.isnan(init_probs)] = 0
        smoothed = stats["span_transition_counts"] + ss
        trans_probs = smoothed / smoothed.sum(axis=0)[None, :]
        trans_probs[np.isnan(trans_probs)] = 0
        mean_lengths = (stats["span_lengths"] + ls) / (stats["span_counts"] + ls)
        with np.errstate(divide="ignore"):
            values = {
                "init_logits": np.log(init_probs),
                "transition_logits": np.log(trans_probs),
                "poisson_log_rates": np.log(mean_lengths),
            }
        values["gaussian_means"] = stats["gaussian_means"]
        values["gaussian_cov"] = stats["gaussian_cov"]
        for name, value in values.items():
            getattr(self, name).copy_(torch.as_tensor(value, dtype=torch.float32))


class SemiMarkovModel(Model):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--sm_max_span_length", type=int, default=20)
        parser.add_argument(
            "--sm_class_shape_bucket",
            type=int,
            default=4,
            help="round each task's class count up to a multiple of this "
            "(padded classes are exactly masked out), so tasks with "
            "different step counts share one batch shape; 1 disables",
        )
        parser.add_argument("--sm_supervised_state_smoothing", type=float, default=1e-2)
        parser.add_argument("--sm_supervised_length_smoothing", type=float, default=1e-1)
        parser.add_argument(
            "--sm_supervised_method",
            choices=["closed-form", "gradient-based", "closed-then-gradient"],
            default="closed-form",
        )
        parser.add_argument(
            "--sm_hidden_markov",
            action="store_true",
            help="train as hidden markov model (fix K=1)",
        )

    @classmethod
    def from_args(cls, args, train_data, device=None):
        device = resolve_device(device)
        for flag in _UNPORTED_FLAGS:
            if getattr(args, flag, None):
                raise NotImplementedError("--{} {}".format(flag, _LATER))
        if getattr(args, "annotate_background_with_previous", False) and not getattr(
            args, "no_merge_classes", False
        ):
            raise NotImplementedError("merging background classes " + _LATER)
        assert args.sm_max_span_length is not None
        n_classes = train_data.corpus.n_classes
        module = GaussianHsmm(
            args,
            n_classes,
            train_data.feature_dim,
            allow_self_transitions=True,
            seed=getattr(args, "seed", 0) or 0,
            device=device,
        )
        return SemiMarkovModel(args, n_classes, train_data.feature_dim, module, device)

    def __init__(self, args, n_classes, feature_dim, module, device=None):
        self.args = args
        self.n_classes = n_classes
        self.feature_dim = feature_dim
        self.module = module
        self.device = resolve_device(device)

    # ----- host-side batch preparation -----

    def _batch_device_args(self, batch):
        """Shared valid classes and dense per-batch numpy arrays
        (vc, cons, end_allowed), class-bucket padded."""
        assert all_equal(
            tuple(ti.tolist()) for ti in batch["task_indices"]
        ), "batch must share valid_classes"
        vc = np.asarray(batch["task_indices"][0], np.int64)
        C_sub = len(vc)
        B, T = batch["features"].shape[:2]
        cons = np.zeros((B, T, C_sub), np.float32)
        end_allowed = np.zeros((B, C_sub), np.float32)

        # class-count bucketing: pad the valid-class set with -1
        # sentinels (masked to BIG_NEG in compute_potentials), exactly as
        # the JAX package pads, so both decode the same shapes
        Cp = pad_class_width(
            C_sub, getattr(self.args, "sm_class_shape_bucket", 1), MAX_CLASSES
        )
        if Cp > C_sub:
            extra = Cp - C_sub
            vc = np.concatenate([vc, np.full(extra, -1, np.int64)])
            cons = np.pad(cons, ((0, 0), (0, 0), (0, extra)))
            end_allowed = np.pad(
                end_allowed, ((0, 0), (0, extra)), constant_values=BIG_NEG
            )
        return vc, cons, end_allowed

    def _pad_batch_rows(self, features, lengths, cons, end_allowed):
        """Pad the batch to --batch_size rows (length-1 dummies) so every
        batch has one shape; the drain drops the dummy rows."""
        B = len(lengths)
        Bp = max(int(getattr(self.args, "batch_size", B) or B), B)
        if Bp == B:
            return features, lengths, cons, end_allowed

        def padz(arr):
            return np.pad(arr, [(0, Bp - B)] + [(0, 0)] * (arr.ndim - 1))

        lengths = np.concatenate([lengths, np.ones(Bp - B, lengths.dtype)])
        return padz(features), lengths, padz(cons), padz(end_allowed)

    # ----- decode -----

    @torch.no_grad()
    def _decode(self, features, lengths, vc, cons, end_allowed):
        """(labels (B, T) global class ids with -1 past each length,
        scores (B,)); every argument a tensor on the model's device.
        Launches work and returns without waiting for it."""
        lengths = lengths.long().clamp(min=1)
        pots = self.module.compute_potentials(features, vc, cons, end_allowed)
        if kernels_supported(self.n_classes):
            labels_sub, scores = hsmm_viterbi_labels(pots, lengths)
        else:
            spans_sub, scores = hsmm_viterbi(pots, lengths)
            t = torch.arange(features.shape[1], device=features.device)[None, :]
            labels_sub = torch.where(t < lengths[:, None], spans_to_labels(spans_sub), -1)
        labels = torch.where(labels_sub >= 0, vc[labels_sub.clamp(min=0)], -1)
        return labels, scores

    # ----- public API -----

    def fit_supervised(self, train_data):
        features, labels = [], []
        for batch in iter_batches(
            train_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            L = int(batch["lengths"][0])
            features.append(batch["features"][0, :L])
            labels.append(batch["gt_single"][0, :L])
        self.module.fit_supervised(features, labels)

    def fit(self, train_data, use_labels, callback_fn=None):
        if not use_labels or self.args.sm_supervised_method != "closed-form":
            raise NotImplementedError(
                "gradient-based and unsupervised training " + _LATER
            )
        self.fit_supervised(train_data)

    def predict(self, test_data):
        drain = DeferredLabelDrain()
        for batch in iter_batches(
            test_data,
            batch_size=self.args.batch_size,
            batch_by_task=True,
            shuffle=False,
            sort_by_length=True,
        ):
            vc, cons, end_allowed = self._batch_device_args(batch)
            B = len(batch["lengths"])
            # fixed-B decode shapes; padded rows are dropped by the drain
            padded = self._pad_batch_rows(
                batch["features"], batch["lengths"], cons, end_allowed
            )
            features, lengths, cons, end_allowed = (upload(x, self.device) for x in padded)
            labels, _ = self._decode(
                features, lengths, upload(vc, self.device), cons, end_allowed
            )
            drain.add((batch["video_name"], batch["lengths"]), labels, n_rows=B)

        predictions = {}
        for (names, lengths_np), all_labels in drain.drain():
            for i, video in enumerate(names):
                L = int(lengths_np[i])
                preds = all_labels[i, :L]
                assert (preds >= 0).all() and (preds < self.n_classes).all()
                predictions[video] = preds
        return predictions
