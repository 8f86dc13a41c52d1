"""Hidden semi-Markov segmentation model, PyTorch.

Twin of ``action_segmentation_tpu/models/semimarkov.py``:

* ``GaussianHsmm`` is an ``nn.Module`` holding the Poisson log-rates,
  Gaussian means, tied diagonal covariance (a frozen buffer), the
  transition/init logits and, with --sm_feature_projection, the NICE
  flow over the features (``models/flow.py``); it builds batched
  ``HsmmPotentials`` for a set of valid classes, with the canonical-order
  start and transition masks and the background merge map as device-side
  gathers and masks, and fits itself in closed form. The compound model
  (``models/compound.py``, --sm_component_model) is a subclass;
* ``SemiMarkovModel`` batches a datasplit (narration penalties and
  per-video end masks included), fits it (closed form, gradient-based
  supervised, generative or discriminative, closed form then gradient,
  or unsupervised by the marginal likelihood, with the flow's log-det
  and the latent's KL) and decodes it, with every label tensor kept on
  the device until one stacked copy at the end. Within
  --sm_device_resident_mb a split goes to the device once
  (``data/resident.py``, cached per split) and each batch is gathered
  there by row index; a split over the budget, with narration on some
  videos only, or a fit with --batch_accumulation above 1 streams its
  batches from the host instead. Both give the same tensors a batch.

The chains follow ``hsmm_cuda.kernel_path``. Decode takes the labels
kernels (K2-max and K3) for a model of <= 128 classes and the exact-spans
kernels (K6 and its traceback) above, on both devices (plain versions on
the CPU). Training's partition runs the kernel forward/backward of
``ops/hsmm_grad.py`` on the card; on the CPU, autograd of
``hsmm_partition`` above 128 classes. On the card only a DP wider than
128 classes raises. ``fit`` writes and resumes train-state checkpoints
(--checkpoint_dir, --checkpoint_every, --resume) and traces its first
epoch with ``torch.profiler`` (--profile_dir); a model pickles onto the
CPU and unpickles onto the device its loader asks for.
``semimarkov_from_reference_state_dict`` builds a model from a
reference-trained state dict.

With --data_parallel and a process group (``parallel/mesh.py``), each
rank holds a replica of the parameters (rank 0's, broadcast before the
first step) and fits and decodes its rows of every batch, padded to a
multiple of the world size at least --batch_size: its loss is its
weighted sums over the batch's count of real videos, the gradients are
summed over the ranks once a step (once a window under
--batch_accumulation) before the mask, the clip and Adam, the epoch's
loss terms once an epoch, and a decode's labels once a batch. Without a
group on one device --data_parallel takes the single path; with several
visible cards it raises.
"""

import contextlib
import itertools
import os
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from action_segmentation_torch import BIG_NEG, checkpoint, resolve_device
from action_segmentation_torch.data.batching import iter_batches, pad_class_width
from action_segmentation_torch.data.resident import (
    build_resident_corpus,
    gather_resident_rows,
)
from action_segmentation_torch.models import flow as nice_flow
from action_segmentation_torch.models.base import (
    DeviceModel,
    batch_generator,
    clip_grads,
    make_optimizer,
    mask_grads,
    set_lr,
    upload,
)
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from action_segmentation_torch.ops.hsmm import (
    HsmmPotentials,
    hsmm_gold_score,
    hsmm_partition,
)
from action_segmentation_torch.ops.hsmm_cuda import (
    MAX_CLASSES,
    hsmm_viterbi_labels,
    hsmm_viterbi_spans,
    kernel_path,
)
from action_segmentation_torch.ops.hsmm_grad import (
    centre_emissions,
    hsmm_partition_centred,
    hsmm_partition_fast,
)
from action_segmentation_torch.ops.span_codec import labels_to_spans, spans_to_labels
from action_segmentation_torch.ops.stats import semimarkov_sufficient_stats
from action_segmentation_torch.parallel.mesh import (
    Shard,
    all_reduce_grads,
    combine_rows,
    data_parallel_mesh,
    pad_batch_for_mesh,
    process_rank,
    reduce_terms,
    replicate_module,
    shard_rows,
    single_mesh,
    terms_to_loss_aux,
    write_on_rank0,
)
from action_segmentation_torch.utils import all_equal, logger
from action_segmentation_torch.utils.drain import DeferredLabelDrain


def _constraint_buffers(n_classes, allowed_starts, allowed_transitions, allowed_ends):
    """Boolean disallowed-masks from allowed sets (semimarkov_modules.py:169-193)."""
    if allowed_starts is None:
        return None, None, None
    init_dis = np.ones(n_classes, bool)
    init_dis[sorted(allowed_starts)] = False
    trans_dis = np.ones((n_classes, n_classes), bool)
    for src, targets in allowed_transitions.items():
        for tgt in targets:
            trans_dis[tgt, src] = False
    return init_dis, trans_dis, allowed_ends


class GaussianHsmm(nn.Module):
    """Gaussian-emission HSMM parameterization.

    Parameters carry the JAX package's ``GaussianHsmm.params`` names (the
    flow's under ``feature_projector``, by the reference's names), so a
    params dict from either side loads into the other
    (``bridge.gaussian_hsmm_params_from_numpy``). The constraint masks
    and the merge map are corpus structure, not weights: non-persistent
    buffers, rebuilt from the datasplit by ``SemiMarkovModel.from_args``
    and absent from the state dict."""

    def __init__(self, args, n_classes, n_dims, allow_self_transitions=False,
                 allowed_starts=None, allowed_transitions=None, allowed_ends=None,
                 merge_classes=None, seed=0, device=None):
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
        init_dis, trans_dis, self.allowed_ends = _constraint_buffers(
            n_classes, allowed_starts, allowed_transitions, allowed_ends
        )
        merge_map = None
        if merge_classes is not None:
            merge_map = np.arange(n_classes)
            for src, sink in merge_classes.items():
                merge_map[src] = sink

        def buffer(x):
            return None if x is None else torch.as_tensor(x, device=device)

        self.register_buffer("init_dis", buffer(init_dis), persistent=False)
        self.register_buffer("trans_dis", buffer(trans_dis), persistent=False)
        self.register_buffer("merge_map", buffer(merge_map), persistent=False)
        self.init_params(torch.Generator().manual_seed(int(seed)), device)
        path = getattr(args, "sm_init_non_projection_parameters_from", None)
        if path:
            self._load_nonprojection_params(path)

    def init_params(self, gen, device):
        f32 = dict(dtype=torch.float32, device=device)
        n_classes, n_dims = self.n_classes, self.feature_dim
        self.poisson_log_rates = nn.Parameter(torch.zeros(n_classes, **f32))
        self.gaussian_means = nn.Parameter(torch.zeros(n_classes, n_dims, **f32))
        # frozen: the covariance is set by moments, never by gradients
        self.register_buffer("gaussian_cov", torch.ones(n_dims, **f32))
        self.transition_logits = nn.Parameter(torch.zeros(n_classes, n_classes, **f32))
        self.init_logits = nn.Parameter(
            torch.rand(n_classes, generator=gen, dtype=torch.float32).to(device)
        )
        self._init_projector(gen, device)

    def _init_projector(self, gen, device):
        """The NICE flow over the features, with --sm_feature_projection."""
        self.feature_projector = None
        if getattr(self.args, "sm_feature_projection", False):
            self.feature_projector = nice_flow.NiceFlow(self.args, self.feature_dim, gen, device)

    def _load_nonprojection_params(self, path):
        """Warm-start every non-flow weight from a pickled model
        (semimarkov_modules.py:90-94, :125-129)."""
        logger.debug("loading all non-flow parameters from {}".format(path))
        other = checkpoint.load_pickle(path, device=self.gaussian_cov.device)
        src = other.module.state_dict() if hasattr(other, "module") else other
        self.load_state_dict(checkpoint.init_subset_from(self.state_dict(), src))

    @property
    def trainable_mask(self):
        """{name: trainable} over the state dict: the covariance is frozen."""
        return {name: name != "gaussian_cov" for name in self.state_dict()}

    def project_features(self, features, lengths=None):
        """(features through the flow, log_det (B,)); without the flow the
        features themselves and zeros. For a (B, T, D) batch with
        `lengths`, log_det sums over each video's real frames only: with
        --flow_scale a padded frame's scale outputs are not zero, and the
        loss would depend on the length bucket."""
        if self.feature_projector is None:
            return features, features.new_zeros(features.shape[0])
        if features.ndim == 3 and lengths is not None:
            h, steps = self.feature_projector(features, per_step=True)
            real = torch.arange(features.shape[1], device=features.device)[None, :] < lengths[:, None]
            return h, (steps * real).sum(dim=1)
        return self.feature_projector(features)

    def compute_potentials(self, features, lengths, vc, constraints_add, end_allowed,
                           generator=None, use_mean_z=True, shard=None):
        """(pots, log_det (B,), kl (B,)) for valid classes `vc` (C_sub,).

        features (B, T, D); lengths (B,) >= 1; constraints_add (B, T,
        C_sub) additive emission penalties; end_allowed (B, C_sub)
        additive end mask. `generator`, `use_mean_z` and `shard` (a
        rank's rows under data parallelism, ``parallel.mesh.Shard``) are
        the compound model's latent (its noise, whether z sits at its
        mean, and the batch its draws and pooling window span); this
        module draws nothing and its kl is zero.

        vc entries of -1 are shape padding (class-count bucketing): their
        initial/transition rows are masked to BIG_NEG before every
        softmax, so they carry no probability mass and are never
        decoded; parameter gathers use a clipped index.
        """
        B = features.shape[0]
        pad = vc < 0
        vcs = vc.clamp(min=0)
        mvc = vcs if self.merge_map is None else self.merge_map[vcs]
        init_mask = pad
        if self.init_dis is not None:
            init_mask = init_mask | self.init_dis[vcs]
        init = initial_log_probs(self.init_logits[vcs], init_mask)
        trans_mask = pad[:, None] | pad[None, :]
        if self.trans_dis is not None:
            trans_mask = trans_mask | self.trans_dis[vcs][:, vcs]
        trans = transition_log_probs(
            self.transition_logits[vcs][:, vcs],
            trans_mask,
            self.allow_self_transitions,
        )
        lens = poisson_length_log_probs(self.poisson_log_rates[mvc], self.max_k)
        feats, log_det = self.project_features(features, lengths)
        emit = gaussian_emission_log_probs(feats, self.gaussian_means[mvc], self.gaussian_cov)
        pots = HsmmPotentials(
            trans=trans.expand((B,) + trans.shape),
            init=init.expand((B,) + init.shape),
            lens=lens.expand((B,) + lens.shape),
            emit=emit + constraints_add,
            end_mask=end_allowed,
        )
        return pots, log_det, features.new_zeros(B)

    def _projected_numpy(self, feature_list):
        """The concatenated (N, D) features, through the flow if any."""
        feats = np.concatenate([np.asarray(f) for f in feature_list], axis=0)
        if self.feature_projector is None:
            return feats
        with torch.no_grad():
            h, _ = self.feature_projector(torch.as_tensor(feats, device=self.gaussian_cov.device))
        return h.cpu().numpy()

    @torch.no_grad()
    def initialize_gaussian(self, feature_list):
        """Mean/variance moment init, of the projected features with the
        flow: every class gets the corpus mean, the covariance is the
        per-dimension sample variance."""
        feats = self._projected_numpy(feature_list)
        mean = torch.as_tensor(feats.mean(axis=0), dtype=torch.float32)
        var = torch.as_tensor(feats.var(axis=0, ddof=1), dtype=torch.float32)
        self.gaussian_means.copy_(mean.expand(self.n_classes, self.feature_dim))
        self.gaussian_cov.copy_(var)

    @torch.no_grad()
    def fit_supervised(self, feature_list, label_list):
        """Smoothed closed-form MLE from span and Gaussian moments. With
        merged classes the durations and Gaussians come from the merged
        labels, the start and transition counts from the unmerged ones."""
        if self.feature_projector is not None:
            raise NotImplementedError("closed-form fit with feature projector")
        if self.trans_dis is not None or self.init_dis is not None:
            raise NotImplementedError("closed-form fit with constrained transitions")
        stats = semimarkov_sufficient_stats(
            feature_list, label_list, n_classes=self.n_classes, max_k=self.max_k
        )
        stats_merged = stats
        if self.merge_map is not None:
            merge_map = self.merge_map.cpu().numpy()
            stats_merged = semimarkov_sufficient_stats(
                feature_list, [merge_map[np.asarray(lab)] for lab in label_list],
                n_classes=self.n_classes, max_k=self.max_k,
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
        mean_lengths = (stats_merged["span_lengths"] + ls) / (
            stats_merged["span_counts"] + ls
        )
        with np.errstate(divide="ignore"):
            values = {
                "init_logits": np.log(init_probs),
                "transition_logits": np.log(trans_probs),
                "poisson_log_rates": np.log(mean_lengths),
            }
        values["gaussian_means"] = stats_merged["gaussian_means"]
        values["gaussian_cov"] = stats_merged["gaussian_cov"]
        for name, value in values.items():
            getattr(self, name).copy_(torch.as_tensor(value, dtype=torch.float32))


# the resident corpora a model keeps at most (least recently used out first)
RESIDENT_LRU = 4


class SemiMarkovModel(DeviceModel):
    # pickled without the plateau controller and the resident corpora
    # (models/base.DeviceModel)
    TRANSIENT = ("_scheduler", "_resident_cache", "_resident_pins", "_resident_failed")

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
        parser.add_argument(
            "--sm_device_resident_mb",
            type=int,
            default=1024,
            help="device memory budget (MB) shared by the datasplits kept on "
            "the device, each uploaded once and batched there by row index; "
            "a split over it streams its batches from the host (the same "
            "batches and results); 0 streams every split",
        )
        parser.add_argument("--sm_supervised_state_smoothing", type=float, default=1e-2)
        parser.add_argument("--sm_supervised_length_smoothing", type=float, default=1e-1)
        parser.add_argument(
            "--sm_supervised_method",
            choices=["closed-form", "gradient-based", "closed-then-gradient"],
            default="closed-form",
        )
        parser.add_argument("--sm_feature_projection", action="store_true", help="use a flow")
        parser.add_argument("--sm_init_non_projection_parameters_from")
        nice_flow.add_args(parser)
        from action_segmentation_torch.models.compound import ComponentHsmm

        ComponentHsmm.add_args(parser)
        parser.add_argument("--sm_component_model", action="store_true")
        parser.add_argument("--sm_constrain_transitions", action="store_true")
        parser.add_argument(
            "--sm_constrain_with_narration",
            choices=["train", "test"],
            nargs="*",
            default=[],
        )
        parser.add_argument("--sm_constrain_narration_weight", type=float, default=-1e4)
        parser.add_argument("--sm_train_discriminatively", action="store_true")
        parser.add_argument(
            "--sm_hidden_markov",
            action="store_true",
            help="train as hidden markov model (fix K=1)",
        )
        # declared by the JAX package and read by neither
        parser.add_argument("--sm_predict_single", action="store_true")

    @classmethod
    def from_args(cls, args, train_data, device=None):
        device = resolve_device(device)
        assert args.sm_max_span_length is not None
        n_classes = train_data.corpus.n_classes
        ordered_indices_by_task = None
        allowed_starts = allowed_transitions = allowed_ends = None
        if getattr(args, "sm_constrain_transitions", False):
            (allowed_starts, allowed_transitions, allowed_ends,
             ordered_indices_by_task) = train_data.get_allowed_starts_and_transitions()
            for src in range(n_classes):  # self-transitions are allowed
                allowed_transitions.setdefault(src, set()).add(src)

        merge_classes = None
        if getattr(args, "annotate_background_with_previous", False) and not getattr(
            args, "no_merge_classes", False
        ):
            # every background of a task shares its first background's
            # durations and Gaussian
            corpus = train_data.corpus
            merge_classes = {}
            for indices in corpus._indices_by_task.values():
                bkg = [ix for ix in indices if ix in corpus._background_indices]
                for ix in indices:
                    sink = bkg[0] if ix in bkg else ix
                    assert merge_classes.get(ix, sink) == sink
                    merge_classes[ix] = sink

        structure = dict(
            allow_self_transitions=True,
            allowed_starts=allowed_starts,
            allowed_transitions=allowed_transitions,
            allowed_ends=allowed_ends,
            merge_classes=merge_classes,
            seed=getattr(args, "seed", 0) or 0,
            device=device,
        )
        if getattr(args, "sm_component_model", False):
            from action_segmentation_torch.models.compound import ComponentHsmm

            if args.sm_component_decompose_steps:
                n_components = train_data.corpus.n_components
                class_to_components = dict(train_data.corpus.label_indices2component_indices)
            else:
                n_components = n_classes
                class_to_components = {c: {c} for c in range(n_classes)}
            module = ComponentHsmm(
                args, n_classes, n_components=n_components,
                class_to_components=class_to_components,
                feature_dim=train_data.feature_dim, **structure,
            )
        else:
            module = GaussianHsmm(args, n_classes, train_data.feature_dim, **structure)
        return SemiMarkovModel(args, n_classes, train_data.feature_dim, module, device,
                               ordered_indices_by_task)

    def __init__(self, args, n_classes, feature_dim, module, device=None,
                 ordered_indices_by_task=None):
        self.args = args
        self.n_classes = n_classes
        self.feature_dim = feature_dim
        self.module = module
        self.device = resolve_device(device)
        self.ordered_indices_by_task = ordered_indices_by_task

    # ----- host-side batch preparation -----

    def _batch_device_args(self, batch, datasplit=None, use_narration=False):
        """Shared valid classes and dense per-batch numpy arrays
        (vc, inv_map, cons, end_allowed), class-bucket padded; inv_map
        maps a global class id to its column among the valid classes.
        cons carries the narration penalties when `use_narration` and the
        batch has constraints; end_allowed each video's end mask when the
        model has allowed ends."""
        tasks = batch["task_name"]
        assert all_equal(
            tuple(ti.tolist()) for ti in batch["task_indices"]
        ), "batch must share valid_classes"
        vc = np.asarray(batch["task_indices"][0], np.int64)
        C_sub = len(vc)
        B, T = batch["features"].shape[:2]
        inv_map = np.zeros(self.n_classes, np.int64)
        inv_map[vc] = np.arange(C_sub)
        if use_narration and "constraints" in batch:
            cons = self._expand_constraints(datasplit, tasks[0], vc, batch["constraints"])
            cons = (cons * self.args.sm_constrain_narration_weight).astype(np.float32)
        else:
            cons = np.zeros((B, T, C_sub), np.float32)
        end_allowed = np.zeros((B, C_sub), np.float32)
        if self.module.allowed_ends is not None:
            for i in range(B):
                end_allowed[i] = self._end_mask_row(vc, tasks[i], batch["lengths"][i])

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
        return vc, inv_map, cons, end_allowed

    def _expand_constraints(self, datasplit, task, vc, constraints):
        """(B, T, K_steps) narration 0/1 -> (B, T, C_sub) penalties of
        (1 - constraint) at each step's column (semimarkov.py:149-157)."""
        vc_list = list(vc)
        step_indices = datasplit.get_ordered_indices_no_background()[task]
        B, T, Ks = constraints.shape
        assert Ks == len(step_indices), (Ks, len(step_indices))
        expanded = np.zeros((B, T, len(vc_list)), np.float32)
        for index, label in enumerate(step_indices):
            expanded[:, :, vc_list.index(label)] = 1.0 - constraints[:, :, index]
        return expanded

    def _end_mask_row(self, vc, task, length):
        """The 0/BIG_NEG end-mask row of one video over valid classes `vc`:
        the allowed ends plus the mid-canonical-order end of a video
        shorter than its step sequence. Shared by batching and
        ``Segmenter``."""
        addl = self._make_additional_allowed_ends([task], [length])[0]
        allowed = set(self.module.allowed_ends) | set(addl)
        mask = np.array([ix in allowed for ix in vc])
        assert mask.any(), "no allowed end classes for instance"
        return np.where(mask, 0.0, BIG_NEG).astype(np.float32)

    def _make_additional_allowed_ends(self, tasks, lengths):
        """Allow ending mid-canonical-order for videos shorter than the
        step sequence (semimarkov.py:135-147)."""
        if self.ordered_indices_by_task is None:
            return [[] for _ in tasks]
        addl = []
        for task, length in zip(tasks, lengths):
            ord_indices = self.ordered_indices_by_task[task]
            if int(length) < len(ord_indices):
                addl.append([ord_indices[int(length) - 1]])
            else:
                addl.append([])
        return addl

    # ----- the resident corpus -----

    def _resident_key(self, datasplit, use_narration):
        """Cache key: the datasplit's identity and every argument the built
        tensors bake in (the narration weight, the class bucket, the
        allowed ends), so a fit after changing one of them rebuilds."""
        ends = self.module.allowed_ends
        return (
            id(datasplit),
            bool(use_narration),
            (
                float(getattr(self.args, "sm_constrain_narration_weight", 1.0))
                if use_narration
                else None
            ),
            int(getattr(self.args, "sm_class_shape_bucket", 1) or 1),
            None if ends is None else tuple(sorted(ends)),
        )

    def _get_resident(self, datasplit, use_narration):
        """The resident corpus of `datasplit` (data/resident.py), or None
        where the split streams: --sm_device_resident_mb 0, over the
        budget, narration on some videos only, or an empty split.

        An entry keeps its datasplit alive while its id() keys the cache,
        which holds at most RESIDENT_LRU splits, least recently used out
        first but never a pinned one (a running fit's). The budget bounds
        the live entries together: eviction runs before the budget left is
        reckoned. A build that failed only because other entries hold the
        budget is not cached; a watermark (the budget left then, with a
        weak reference to its split, since an id() may be reused) keeps
        the split from being read again until more is free. Errors raise."""
        budget = getattr(self.args, "sm_device_resident_mb", 0) or 0
        if budget <= 0:
            logger.debug("resident corpus: --sm_device_resident_mb {}; streaming".format(budget))
            return None
        if not hasattr(self, "_resident_cache"):
            self._resident_cache = OrderedDict()
            self._resident_pins = set()
            self._resident_failed = {}
        key = self._resident_key(datasplit, use_narration)
        if key in self._resident_cache:
            self._resident_cache.move_to_end(key)
            return self._resident_cache[key][1]
        for old in list(self._resident_cache):
            if len(self._resident_cache) < RESIDENT_LRU:
                break
            if old not in self._resident_pins:
                self._resident_cache.pop(old)
        held = sum(res.nbytes for _, res in self._resident_cache.values() if res is not None)
        remaining_mb = budget - held / float(1 << 20)
        failed = self._resident_failed.get(key)
        if failed is not None:
            ref, failed_at = failed
            if ref() is not datasplit:
                # a dead or another referent: the mark was some other split's
                self._resident_failed.pop(key, None)
            elif remaining_mb <= failed_at:
                logger.debug("resident corpus: still over the {:.1f} MB left; "
                             "streaming".format(remaining_mb))
                return None
        reason = {}
        built = build_resident_corpus(
            self, datasplit, use_narration, remaining_mb, reason_out=reason
        )
        if built is None and reason.get("why") == "budget" and remaining_mb < budget:
            self._resident_failed[key] = (weakref.ref(datasplit), remaining_mb)
            return None
        self._resident_failed.pop(key, None)
        self._resident_cache[key] = (datasplit, built)
        return built

    def _pin_resident(self, datasplit, use_narration):
        if hasattr(self, "_resident_pins"):
            self._resident_pins.add(self._resident_key(datasplit, use_narration))

    def _unpin_resident(self, datasplit, use_narration):
        if hasattr(self, "_resident_pins"):
            self._resident_pins.discard(self._resident_key(datasplit, use_narration))

    # ----- decode -----

    @torch.no_grad()
    def _decode(self, features, lengths, vc, cons, end_allowed, shard=None):
        """(labels (B, T) global class ids with -1 past each length,
        scores (B,)); every argument a tensor on the model's device, the
        rows of `shard` under data parallelism. Launches work and returns
        without waiting for it."""
        lengths = lengths.long().clamp(min=1)
        pots, _, _ = self.module.compute_potentials(
            features, lengths, vc, cons, end_allowed, use_mean_z=True, shard=shard
        )
        path = kernel_path(self.n_classes, pots.emit.shape[-1], features.device)
        if path.decode == "labels":
            labels_sub, scores = hsmm_viterbi_labels(pots, lengths)
        else:
            spans_sub, scores = hsmm_viterbi_spans(pots, lengths)
            t = torch.arange(features.shape[1], device=features.device)[None, :]
            labels_sub = torch.where(t < lengths[:, None], spans_to_labels(spans_sub), -1)
        labels = torch.where(labels_sub >= 0, vc[labels_sub.clamp(min=0)], -1)
        return labels, scores

    # ----- training -----

    def _loss(self, features, lengths, vc, inv_map, gt, cons, end_allowed,
              weights, use_labels, generator=None, denom=None, shard=None):
        """(loss, aux) of one batch, the JAX package's ``_build_loss_fn``
        and, over a rank's rows, its data-parallel ``_make_local_loss``.

        Generative supervised: -wmean(gold score); discriminative:
        -wmean(gold - logZ); unsupervised: -wmean(logZ). The flow's
        -wmean(log_det) is added, and unsupervised the latent's
        wmean(kl), whose z is drawn from `generator` (supervised, z sits
        at its mean). Every mean is a sum weighted by `weights` (padded
        rows weigh 0 and have length 1) over `denom`, the batch's count
        of real videos (None: the weights' sum), so padding never changes
        the loss. Under data parallelism (`shard`, a rank's rows) the
        loss is this rank's share of the batch's, whose gradient the
        ranks sum. aux holds the means and ``terms``, the weighted sums
        (nll, kl, log_det) the epoch's stats reduce. The partition goes
        through the kernel forward/backward (``kernel_path``) over
        emissions centred frame by frame (``centre_emissions``): logZ is
        the centred DP's plus the offset, and the discriminative loss
        scores the gold path on the same centred emissions, whose offset
        cancels logZ's."""
        lengths = lengths.long().clamp(min=1)
        if denom is None:
            denom = weights.sum().clamp(min=1.0)
        else:
            denom = torch.full((), max(float(denom), 1.0), device=weights.device)

        def wsum(x):
            return (x * weights).sum()

        pots, log_det, kl = self.module.compute_potentials(
            features, lengths, vc, cons, end_allowed, generator, use_mean_z=use_labels,
            shard=shard,
        )
        path = kernel_path(self.n_classes, pots.emit.shape[-1], features.device)
        partition = hsmm_partition_fast if path.partition == "kernels" else hsmm_partition
        if use_labels:
            spans = labels_to_spans(inv_map[gt], self.module.max_k)
            if getattr(self.args, "sm_train_discriminatively", False):
                centred, _ = centre_emissions(pots, lengths)  # the offsets cancel
                ll = hsmm_gold_score(centred, lengths, spans) - partition(centred, lengths)
            else:
                ll = hsmm_gold_score(pots, lengths, spans)
        else:
            ll = hsmm_partition_centred(pots, lengths, partition)
        nll_s, kl_s, log_det_s = wsum(-ll), wsum(kl), wsum(log_det)
        loss = (nll_s - log_det_s) / denom
        if not use_labels:
            loss = loss + kl_s / denom
        terms = torch.stack([nll_s, kl_s, log_det_s]).detach()
        return loss, {"nll": terms[0] / denom, "kl": terms[1] / denom,
                      "log_det": terms[2] / denom, "terms": terms}

    def _training_batch(self, batch, datasplit=None, use_narration=False, mesh=None):
        """One collated batch as padded tensors on the device: (features,
        lengths, vc, inv_map, gt, cons, end_allowed, weights), this rank's
        rows of it under data parallelism (`mesh`; None: this process's
        ``single_mesh``, every row)."""
        vc, inv_map, cons, end_allowed = self._batch_device_args(
            batch, datasplit, use_narration
        )
        gt = batch.get("gt_single", np.zeros(batch["features"].shape[:2], np.int64))
        features, lengths, gt, cons, end_allowed, weights = self._pad_batch_rows(
            mesh or single_mesh(self.device), batch["features"], batch["lengths"], gt, cons,
            end_allowed)
        return tuple(
            upload(x, self.device)
            for x in (features, lengths, vc, inv_map, gt, cons, end_allowed, weights)
        )

    def _pad_batch_rows(self, mesh, features, lengths, *rest):
        """This rank's rows of a batch padded as JAX pads it for its mesh
        (``pad_batch_for_mesh`` to --batch_size rows, rounded up to the
        world: weight-0, length-1 dummies, so every batch has one shape):
        (features, lengths, *rest, weights (rows,)). The drain drops the
        dummy rows of a decode, and every sum of the training loss is
        weighted."""
        B = len(lengths)
        padded, weights = pad_batch_for_mesh(mesh, [features, lengths, *rest], B,
                                             pad_to=getattr(self.args, "batch_size", None))
        padded[1][B:] = 1
        return tuple(shard_rows(mesh, x) for x in (*padded, weights))

    def _batch_shard(self, mesh, size):
        """This rank's Shard of a batch of `size` real videos: the single
        path's --batch_size rows (at least `size`), padded to the world."""
        single = max(int(getattr(self.args, "batch_size", None) or 0), size)
        return Shard(mesh, -(-single // mesh.world) * mesh.world, single)

    def _moment_init(self, train_data):
        """Moment-match the emissions on the first shuffled 100-video batch."""
        feats = []
        for batch in iter_batches(
            train_data, batch_size=100, batch_by_task=False, shuffle=True,
            seed=getattr(self.args, "seed", 1), bucket=False,
        ):
            for i in range(len(batch["lengths"])):
                feats.append(batch["features"][i, : batch["lengths"][i]])
            break
        self.module.initialize_gaussian(feats)

    # ----- public API -----

    def fit_supervised(self, train_data):
        assert not getattr(self.args, "sm_constrain_transitions", False)
        features, labels = [], []
        for batch in iter_batches(
            train_data, batch_size=1, batch_by_task=False, shuffle=False, bucket=False
        ):
            L = int(batch["lengths"][0])
            features.append(batch["features"][0, :L])
            labels.append(batch["gt_single"][0, :L])
        self.module.fit_supervised(features, labels)

    def fit(self, train_data, use_labels, callback_fn=None):
        """Fit on `train_data`: closed form, or Adam over shuffled batches.

        The streaming loop of the JAX package's ``fit``: a moment init
        (unless the closed form ran first), then per epoch the batches of
        ``iter_batches(shuffle=True, seed=seed + epoch)`` (at most
        --train_limit), one Adam step per batch or per --batch_accumulation
        window (a partial window at the epoch's end is dropped), the norm
        clip, and the plateau controller after the epoch.
        ``callback_fn(epoch, stats)`` gets the epoch's train_loss,
        train_nll_frame_avg, train_kl_vid_avg and train_recon_bound. The
        losses stay on the device until one fetch per epoch.

        With --checkpoint_dir the train state is written after every
        --checkpoint_every-th epoch (``checkpoint.save_checkpoint``);
        --resume restores the latest one (params, Adam's moments, the
        plateau controller) and starts at the epoch after it, whose
        batches are those the uninterrupted run had. --profile_dir
        traces the first epoch run with ``torch.profiler``.

        Without --batch_accumulation the batches come from the split's
        resident corpus where it has one (``_get_resident``): the same
        batches in the same order, gathered on the device, pinned in the
        cache while the epochs run.

        With --data_parallel under a process group every rank runs this
        loop on its rows of each batch (``_data_parallel_mesh``); rank 0
        alone writes checkpoints and traces."""
        args = self.args
        if getattr(args, "model_parallel", 1) not in (None, 1):
            raise NotImplementedError(
                "--model_parallel > 1 was retired in the JAX package; use "
                "--data_parallel"
            )
        if use_labels:
            assert not getattr(args, "sm_constrain_transitions", False)
        mesh = self._data_parallel_mesh()
        use_narration = "train" in getattr(args, "sm_constrain_with_narration", [])
        method = args.sm_supervised_method
        if use_labels and method in ("closed-form", "closed-then-gradient"):
            self.fit_supervised(train_data)
            if method == "closed-form":
                replicate_module(mesh, self.module)
                return
            if callback_fn:
                callback_fn(-1, {})
        else:
            self._moment_init(train_data)

        named = list(self.module.named_parameters())
        optimizer, scheduler = make_optimizer(args, [p for _, p in named])
        # exposed for tests (resume restores its lr, best and num_bad)
        self._scheduler = scheduler
        lr = args.lr
        resident = None
        if args.batch_accumulation > 1:
            logger.debug("resident corpus: --batch_accumulation {}; streaming".format(
                args.batch_accumulation))
        else:
            resident = self._get_resident(train_data, use_narration)
        start_epoch = 0
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir and getattr(args, "resume", False):
            step = checkpoint.latest_step(ckpt_dir)
            if step is not None:
                lr = self._restore(ckpt_dir, step, optimizer, scheduler, lr)
                start_epoch = step + 1
                logger.debug("resumed from {} at epoch {} (lr {})".format(
                    ckpt_dir, start_epoch, lr))
        # the ranks start from rank 0's parameters (after the moment init,
        # the closed form or the resume) and stay equal
        replicate_module(mesh, self.module)
        if mesh.world > 1:
            logger.debug("data-parallel training over {} ranks".format(mesh.world))
        profile_dir = getattr(args, "profile_dir", None) if process_rank() == 0 else None
        if resident is not None:
            # held for the whole fit: an eviction would count its memory free
            self._pin_resident(train_data, use_narration)
        try:
            for epoch in range(start_epoch, args.epochs):
                with self._profiled(profile_dir if epoch == start_epoch else None, epoch):
                    epoch_stats = self._train_epoch(
                        train_data, epoch, optimizer, named, lr, use_labels, use_narration,
                        resident, mesh,
                    )
                new_lr = lr
                if scheduler is not None:
                    new_lr = scheduler.step(epoch_stats["train_loss"])
                if ckpt_dir and epoch % getattr(args, "checkpoint_every", 5) == 0:
                    # the rate this epoch ran at, and the plateau controller's
                    # post-step state, which governs the next epoch
                    write_on_rank0(
                        checkpoint.save_checkpoint,
                        {"params": self.module.state_dict(),
                         "opt_state": optimizer.state_dict()},
                        args, epoch, ckpt_dir, lr=lr,
                        sched_state=None if scheduler is None else vars(scheduler),
                    )
                lr = new_lr
                set_lr(optimizer, lr)
                if callback_fn:
                    callback_fn(epoch, epoch_stats)
        finally:
            self._unpin_resident(train_data, use_narration)

    def _restore(self, ckpt_dir, step, optimizer, scheduler, lr):
        """Load the train state of checkpoint `step` into the module, the
        optimizer and the plateau controller; returns the learning rate
        the next epoch runs at."""
        state, _, _ = checkpoint.load_checkpoint(ckpt_dir, step)
        self.module.load_state_dict(state["params"])
        optimizer.load_state_dict(state["opt_state"])
        meta = checkpoint.load_meta(ckpt_dir, step) or {}
        if meta.get("sched") is not None and scheduler is not None:
            # the post-step plateau state: the resumed epoch sees the
            # best/num_bad the uninterrupted run had, not a reset that
            # would skip a pending cut
            sched = meta["sched"]
            scheduler.lr, scheduler.best, scheduler.num_bad = (
                float(sched["lr"]), float(sched["best"]), int(sched["num_bad"]))
            lr = scheduler.lr
        elif meta.get("lr") is not None:
            lr = float(meta["lr"])
            if scheduler is not None:
                scheduler.lr = lr
        set_lr(optimizer, lr)
        return lr

    @contextlib.contextmanager
    def _profiled(self, profile_dir, epoch):
        """Trace the block with ``torch.profiler`` (the host and, on the
        card, its kernels) into one Chrome trace in `profile_dir`; a
        no-op when `profile_dir` is None."""
        if not profile_dir:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        path = os.path.join(profile_dir, "epoch_{}.pt.trace.json".format(epoch))
        prof.export_chrome_trace(path)
        logger.debug("wrote a profiler trace of epoch {} to {}".format(epoch, path))

    def _data_parallel_mesh(self):
        """The Mesh of --data_parallel (``parallel.mesh.data_parallel_mesh``);
        without the flag, this process's world-1 ``single_mesh``."""
        if not getattr(self.args, "data_parallel", False):
            return single_mesh(self.device)
        return data_parallel_mesh(self.device)

    def _train_epoch(self, train_data, epoch, optimizer, named, lr, use_labels,
                     use_narration, resident, mesh):
        """One epoch of Adam steps at rate `lr`, its batches streamed from
        `train_data` or gathered from its `resident` corpus, this rank's
        rows of each under a `mesh`; returns the callback stats. The
        gradients are summed over the ranks before the mask, the clip and
        Adam, so the logged norm is the global one."""
        args = self.args
        params = [p for _, p in named]
        trainable = self.module.trainable_mask
        window = max(1, args.batch_accumulation)
        seed = (getattr(args, "seed", 1) or 1) + epoch
        start_time = time.time()
        num_frames = num_videos = 0
        terms, sizes, log_rows = [], [], []
        pending = 0
        optimizer.zero_grad(set_to_none=True)
        if resident is None:
            batches = self._streamed_batches(train_data, seed, use_narration, mesh)
        else:
            batches = self._resident_batches(resident, seed, mesh)
        for batch_ix, B, frames, batch, shard in batches:
            num_videos += B
            num_frames += frames
            loss, aux = self._loss(
                *batch, use_labels=use_labels,
                generator=self._noise_generator(epoch, batch_ix, use_labels),
                denom=B, shard=shard,
            )
            loss.backward()
            terms.append(aux["terms"])
            sizes.append(float(B))
            pending += 1
            if pending < window:
                continue
            all_reduce_grads(mesh, params)
            if pending > 1:  # the window's mean gradient
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(pending)
            mask_grads(named, trainable)
            gnorm = clip_grads(params, args.max_grad_norm)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            pending = 0
            if args.print_every and batch_ix % args.print_every == 0:
                log_rows.append((batch_ix, num_videos, num_frames, len(terms) - 1,
                                 gnorm.detach().float().reshape(1)))
        stats, losses, log_rows = self._epoch_stats(terms, sizes, log_rows, use_labels, mesh)
        return self._finish_epoch(
            epoch, lr, stats, losses, log_rows, num_videos, num_frames, start_time
        )

    def _epoch_stats(self, terms, sizes, log_rows, use_labels, mesh):
        """The epoch's stats fold (count, loss_sum, nll*B, kl*B, log_det*B),
        its per-batch losses and its log lines' vectors (|GParam| and the
        fold's nll, kl and log_det at the line's batch), from the batches'
        loss terms summed over the ranks in one collective, all on the
        device."""
        if not terms:
            return torch.zeros(5, device=self.device), torch.zeros(0, device=self.device), []
        summed = reduce_terms(mesh, torch.stack(terms))
        bw = torch.tensor(sizes, device=self.device)
        loss, aux = terms_to_loss_aux(summed, bw, use_labels)
        fold = torch.stack([torch.ones_like(loss), loss, aux["nll"] * bw, aux["kl"] * bw,
                            aux["log_det"] * bw], dim=1).cumsum(dim=0)
        rows = [(bix, nvid, nfrm, torch.cat([gnorm, fold[i, 2:]]))
                for bix, nvid, nfrm, i, gnorm in log_rows]
        return fold[-1], loss, rows

    def _streamed_batches(self, train_data, seed, use_narration, mesh):
        """(batch index, videos, frames, _training_batch's tensors, this
        rank's Shard) of the batches of iter_batches(shuffle=True, seed),
        at most --train_limit."""
        batches = iter_batches(
            train_data, batch_size=self.args.batch_size, batch_by_task=True,
            shuffle=True, seed=seed,
        )
        if self.args.train_limit:
            batches = itertools.islice(batches, self.args.train_limit)
        for batch_ix, batch in enumerate(batches):
            B = len(batch["lengths"])
            yield (batch_ix, B, int(batch["lengths"].sum()),
                   self._training_batch(batch, train_data, use_narration, mesh),
                   self._batch_shard(mesh, B))

    def _resident_batches(self, resident, seed, mesh):
        """The same batches as ``_streamed_batches``, in the same order,
        gathered from the resident corpus (this rank's rows under a
        `mesh`): the plan's matrices go to the device in one copy; no
        batch copies or waits."""
        plan = resident.make_plan(self.args.batch_size, shuffle=True, seed=seed,
                                  limit=self.args.train_limit, global_order=True,
                                  pad_rows_to=mesh.world)
        table = resident.upload_plan(plan)
        for b in plan.batches():
            shard = self._batch_shard(mesh, b.size)
            yield (b.bix, b.size, b.frames,
                   gather_resident_rows(resident, table, b, rows=(shard.start, shard.stop)),
                   shard)

    def _noise_generator(self, epoch, batch_ix, use_labels):
        """The generator of one training batch's latent noise, on the
        model's device, seeded from (--seed, epoch, batch): never a
        running stream, so a resumed epoch draws what the uninterrupted
        run drew. None where nothing is drawn (no latent, or supervised,
        where z sits at its mean)."""
        if use_labels or getattr(self.module, "z_dim", 0) == 0:
            return None
        return batch_generator(getattr(self.args, "seed", 0), epoch, batch_ix, self.device)

    def _finish_epoch(self, epoch, lr, stats, losses, log_rows, num_videos,
                      num_frames, start_time):
        """The epoch's one fetch: stats, per-batch losses and log lines in
        one stacked copy; logs non-finite losses and the print_every
        lines; returns the callback stats."""
        flat = torch.cat([stats, losses] + [v for *_, v in log_rows]).tolist()
        elapsed = max(time.time() - start_time, 1e-9)
        for bix, loss in enumerate(flat[5 : 5 + len(losses)]):
            if not np.isfinite(loss):
                logger.debug("WARNING: non-finite loss {} at epoch {} batch {}".format(
                    loss, epoch, bix))
        off = 5 + len(losses)
        for i, (bix, nvid, nfrm, _) in enumerate(log_rows):
            gnorm, nll_c, kl_c, ld_c = flat[off + 4 * i : off + 4 * i + 4]
            logger.debug(
                "Epoch: %02d, Batch: %03d, |GParam|: %.2f, lr: %.2E, loss: %.4f, "
                "recon: %.4f, kl: %.4f, log_det: %.4f, Throughput: %.2f vid / sec"
                % (epoch, bix, gnorm, lr, (nll_c + kl_c + ld_c) / nvid, nll_c / nfrm,
                   kl_c / nfrm, ld_c / nvid, nvid / elapsed)
            )
        if num_videos == 0:
            return {"train_loss": 0.0, "train_nll_frame_avg": 0.0,
                    "train_kl_vid_avg": 0.0, "train_recon_bound": 0.0}
        count, loss_sum, nll_c, kl_c = flat[:4]
        nf, nv = float(max(num_frames, 1)), float(max(num_videos, 1))
        return {
            "train_loss": loss_sum / max(count, 1.0),
            "train_nll_frame_avg": nll_c / nf,
            "train_kl_vid_avg": kl_c / nv,
            "train_recon_bound": (nll_c + kl_c) / nf,
        }

    def predict(self, test_data):
        """{video name: labels} of every video of `test_data`, decoded in
        length-sorted batches of --batch_size, from the split's resident
        corpus where it has one (``_get_resident``), else streamed. With
        --data_parallel under a process group each rank decodes its rows of
        every batch and every rank gets the whole batch's labels."""
        use_narration = "test" in getattr(self.args, "sm_constrain_with_narration", [])
        mesh = self._data_parallel_mesh()
        resident = self._get_resident(test_data, use_narration)
        if resident is not None:
            return self._predict_resident(resident, mesh)
        drain = DeferredLabelDrain()
        for batch in iter_batches(
            test_data,
            batch_size=self.args.batch_size,
            batch_by_task=True,
            shuffle=False,
            sort_by_length=True,
        ):
            vc, _, cons, end_allowed = self._batch_device_args(
                batch, test_data, use_narration
            )
            B = len(batch["lengths"])
            # fixed-B decode shapes; padded rows are dropped by the drain
            shard = self._batch_shard(mesh, B)
            features, lengths, cons, end_allowed, _ = self._pad_batch_rows(
                mesh, batch["features"], batch["lengths"], cons, end_allowed)
            features, lengths, cons, end_allowed = (
                upload(x, self.device) for x in (features, lengths, cons, end_allowed)
            )
            labels, _ = self._decode(
                features, lengths, upload(vc, self.device), cons, end_allowed, shard
            )
            labels = combine_rows(mesh, labels, shard.padded)
            drain.add((batch["video_name"], batch["lengths"]), labels, n_rows=B)
        return self._drained_predictions(drain)

    def _predict_resident(self, resident, mesh):
        """predict's batches gathered from the resident corpus: the plan
        (sort_by_length, the streaming batches) goes to the device in one
        copy, every batch decodes through ``_decode`` in the streaming
        order (this rank's rows under a `mesh`, then the batch's labels
        combined), and the labels come back in one copy."""
        plan = resident.make_plan(self.args.batch_size, shuffle=False, seed=1,
                                  sort_by_length=True,
                                  pad_rows_to=mesh.world)
        table = resident.upload_plan(plan)
        drain = DeferredLabelDrain()
        for b in plan.batches():
            shard = self._batch_shard(mesh, b.size)
            features, lengths, vc, _, _, cons, end_allowed, _ = gather_resident_rows(
                resident, table, b, with_gt=False, rows=(shard.start, shard.stop))
            labels, _ = self._decode(features, lengths, vc, cons, end_allowed, shard)
            labels = combine_rows(mesh, labels, shard.padded)
            rows = [resident.row_of[key] for key in b.keys]
            drain.add(([name for _, name in b.keys], resident.host_len[rows]), labels,
                      n_rows=b.size)
        return self._drained_predictions(drain)

    def _drained_predictions(self, drain):
        """{video name: labels over its length} from the drain's one copy."""
        predictions = {}
        for (names, lengths_np), all_labels in drain.drain():
            for i, video in enumerate(names):
                L = int(lengths_np[i])
                preds = all_labels[i, :L]
                assert (preds >= 0).all() and (preds < self.n_classes).all()
                predictions[video] = preds
        return predictions


def _set_flow_args(args, flow_flags):
    """Set the NICE flow's flags from an imported flow's shapes (None: no
    flow), so the pickled args stay coherent with the weights."""
    args.sm_feature_projection = flow_flags is not None
    if flow_flags is not None:
        for key, value in flow_flags.items():
            setattr(args, key, value)
        args.flow_scale_no_zero = getattr(args, "flow_scale_no_zero", False)


def semimarkov_from_reference_state_dict(args, state_dict, device=None):
    """A serving-ready SemiMarkovModel on `device` (None: the card) from a
    reference-trained state_dict (torch or numpy leaves): a Gaussian
    SemiMarkovModule or a ComponentSemiMarkovModule (told apart by the
    embedding tables), with a flow and a VAE encoder where it has them.

    A compound model's components map to classes one for one (the
    reference's default, semimarkov.py:85-90): a
    --sm_component_decompose_steps model carries corpus structure that a
    state dict does not hold. Transition and end constraints are corpus
    structure too: rebuild them through SemiMarkovModel.from_args to
    decode with --sm_constrain_transitions."""
    device = resolve_device(device)
    names = {k[len("model."):] if k.startswith("model.") else k for k in state_dict}
    if "initial_embeddings.weight" in names:
        from action_segmentation_torch.models.compound import ComponentHsmm

        params, meta = checkpoint.compound_params_from_reference_state_dict(
            state_dict, device=device)
        n_classes = meta["n_classes"] or meta["n_components"]
        assert meta["n_components"] == n_classes, (
            "a decomposed-steps compound model needs the corpus's component structure")
        if meta["n_classes"] is None:
            logger.debug(
                "WARNING: compound state_dict has no per-class biases; assuming the "
                "identity class->component structure (n_classes = n_components = {})"
                .format(n_classes))
        args.sm_component_model = True
        args.sm_component_embedding_dim = meta["embedding_dim"]
        args.sm_component_mean_layers = meta["mean_layers"]
        args.sm_component_length_layers = meta["length_layers"]
        args.sm_component_z_dim = meta["z_dim"]
        args.sm_compound_structure = meta["compound_structure"]
        if meta["z_dim"] > 0:
            args.sm_component_z_hidden_dim = meta["z_hidden_dim"]
            args.seq_num_layers_component = meta["encoder_layers"]
        _set_flow_args(args, meta.get("flow"))
        feature_dim = meta["feature_dim"]
        module = ComponentHsmm(
            args, n_classes, n_components=meta["n_components"],
            class_to_components={c: {c} for c in range(n_classes)},
            feature_dim=feature_dim, allow_self_transitions=True,
            per_class_bias=meta["per_class_bias"], device=device,
        )
    else:
        params, skipped = checkpoint.params_from_reference_state_dict(state_dict, device=device)
        if skipped:
            logger.debug("import: skipping non-parameter keys {}".format(skipped))
        n_classes, feature_dim = params["gaussian_means"].shape
        flow = None
        if any(k.startswith(checkpoint.FLOW_PREFIX) for k in params):
            flow = checkpoint.flow_params_from_reference_state_dict(params)[1]
        _set_flow_args(args, flow)
        module = GaussianHsmm(args, n_classes, feature_dim, allow_self_transitions=True,
                              device=device)
    module.load_state_dict(params)
    return SemiMarkovModel(args, n_classes, feature_dim, module, device)
