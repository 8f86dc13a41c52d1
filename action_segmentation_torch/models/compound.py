"""Compound (neural) HSMM parameterization with an optional VAE latent.

Twin of ``action_segmentation_tpu/models/compound.py`` (the reference's
ComponentSemiMarkovModule, semimarkov_modules.py:699-970): classes embed
as the mean of their component embeddings, and MLP heads produce the
initial and transition logits, the emission means and the Poisson length
log-rates, optionally conditioned on a per-video latent z that a BiLSTM
encoder infers (its KL enters the unsupervised loss).

The reference's per-class EmbeddingBag gathers are one dense
(n_classes, n_components) row-normalised membership matmul, so the class
embeddings of any valid-class subset are rows of a single product. The
state dict carries the reference's names (``initial_embeddings.weight``,
``emission_mean_mlp.1.lin1.weight``, ``encoder.encoder.weight_ih_l0``,
``feature_projector.cell0.in_layer.weight``...), so a reference state
dict loads by name once its (D, D) covariance is cut to its diagonal
(``checkpoint.compound_params_from_reference_state_dict``).
"""

import numpy as np
import torch
from torch import nn

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.models.nn import linear, residual_mlp, xavier_uniform
from action_segmentation_torch.models.rnn import LSTMEncoder
from action_segmentation_torch.models.semimarkov import GaussianHsmm
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    poisson_length_log_probs,
)
from action_segmentation_torch.ops.hsmm import HsmmPotentials
from action_segmentation_torch.parallel.mesh import batch_max, shard_noise, whole_batch

EMBEDDINGS = ("initial", "transition", "emission", "length")


class ComponentHsmm(GaussianHsmm):
    """Neural/compound HSMM factors; shares GaussianHsmm's constraint and
    merge plumbing and its DP interface, and produces per-video factors
    when a latent z is active."""

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--sm_component_decompose_steps", action="store_true")
        parser.add_argument("--sm_component_mean_layers", type=int, default=2)
        parser.add_argument("--sm_component_length_layers", type=int, default=2)
        parser.add_argument("--sm_component_embedding_dim", type=int, default=100)
        parser.add_argument("--sm_component_z_dim", type=int, default=0)
        parser.add_argument("--sm_component_z_hidden_dim", type=int, default=100)
        parser.add_argument(
            "--no_sm_compound_structure",
            action="store_false",
            dest="sm_compound_structure",
        )
        parser.add_argument("--seq_num_layers_component", type=int, default=2)
        parser.add_argument(
            "--sm_reference_pooling",
            action="store_true",
            help="pool the VAE encoder's outputs as the reference does, over "
            "frames zero-padded to the batch's longest video, so z depends "
            "on the batch; by default the pool is over each video's own "
            "frames. Use it to decode a migrated reference model whose "
            "batched outputs must match frame for frame.",
        )

    def __init__(self, args, n_classes, n_components, class_to_components, feature_dim,
                 allow_self_transitions=False, per_class_bias=True, allowed_starts=None,
                 allowed_transitions=None, allowed_ends=None, merge_classes=None, seed=0,
                 device=None):
        # plain attributes, read by init_params during GaussianHsmm.__init__
        self.n_components = n_components
        self.embedding_dim = args.sm_component_embedding_dim
        self.z_dim = args.sm_component_z_dim
        self.compound_structure = getattr(args, "sm_compound_structure", True)
        self.structure_uses_z = self.compound_structure and self.z_dim > 0
        self.per_class_bias = per_class_bias
        member = np.zeros((n_classes, n_components), np.float32)
        for cls, comps in class_to_components.items():
            for comp in comps:
                member[cls, comp] = 1.0
        member /= np.maximum(member.sum(axis=1, keepdims=True), 1.0)
        self._membership = member
        super().__init__(
            args, n_classes, feature_dim, allow_self_transitions=allow_self_transitions,
            allowed_starts=allowed_starts, allowed_transitions=allowed_transitions,
            allowed_ends=allowed_ends, merge_classes=merge_classes, seed=seed, device=device,
        )

    def init_params(self, gen, device):
        args = self.args
        e = self.embedding_dim
        ez = e + self.z_dim
        se = ez if self.compound_structure else e
        D = self.feature_dim
        f32 = dict(dtype=torch.float32, device=device)
        # corpus structure, not a weight: rebuilt by from_args
        self.register_buffer("class_component_matrix",
                             torch.as_tensor(self._membership, device=device),
                             persistent=False)
        for name in EMBEDDINGS:
            table = nn.Embedding(self.n_components, e, device="meta")
            table.weight = nn.Parameter(xavier_uniform((self.n_components, e), gen).to(device))
            setattr(self, name + "_embeddings", table)
        self.initial_weights = linear(se, 1, gen, xavier=True, device=device)
        self.transition_weights = linear(se, se, gen, xavier=True, device=device)
        self.emission_mean_mlp = residual_mlp(ez, e, D, args.sm_component_mean_layers, gen,
                                              device=device)
        self.emission_mean_bias = nn.Parameter(torch.zeros(D, **f32))
        self.length_mlp = residual_mlp(se, e, 1, args.sm_component_length_layers, gen,
                                       device=device)
        self.register_buffer("gaussian_cov", torch.ones(D, **f32))
        if self.per_class_bias:
            for name in ("initial_bias", "transition_bias", "length_bias"):
                setattr(self, name, nn.Parameter(torch.zeros(self.n_classes, **f32)))
        if self.z_dim > 0:
            # xavier weights: the reference's dim > 1 override reaches the
            # encoder's LSTM too
            self.encoder = LSTMEncoder(
                D, args.sm_component_z_hidden_dim // 2, gen,
                num_layers=getattr(args, "seq_num_layers_component", 2), xavier_w=True,
                device=device,
            )
            self.encoder_to_params = linear(args.sm_component_z_hidden_dim, 2 * self.z_dim,
                                            gen, xavier=True, device=device)
        self._init_projector(gen, device)

    @torch.no_grad()
    def initialize_gaussian(self, feature_list):
        """Moment init in the emissions' input space: with the flow, the
        moments of the projected features (semimarkov_modules.py:263-274;
        the covariance is frozen, so a raw-space variance would mis-scale
        every emission for the whole run)."""
        feats = self._projected_numpy(feature_list)
        self.emission_mean_bias.copy_(torch.as_tensor(feats.mean(axis=0)))
        self.gaussian_cov.copy_(torch.as_tensor(feats.var(axis=0, ddof=1)))

    def fit_supervised(self, feature_list, label_list):
        raise NotImplementedError("closed-form fit not supported for component model")

    # ----- latent ------------------------------------------------------

    def _noise(self, batch, generator, device):
        """(batch, z_dim) standard normal draws from `generator`."""
        if generator is None:
            raise ValueError("a sampled z needs a generator (or use_mean_z=True)")
        return torch.randn((batch, self.z_dim), generator=generator, device=device)

    def _get_z_and_kl(self, features, lengths, generator, use_mean, shard=None):
        """(z (B, z_dim), kl (B,)) of the encoder's posterior; z is its
        mean with `use_mean`, else one draw from `generator`. Without a
        latent, (zeros (B, 1), zeros (B,)). `shard`: this rank's rows of
        the batch under data parallelism (None: every row, ``whole_batch``)."""
        B, T = features.shape[:2]
        shard = shard or whole_batch(B, features.device)
        if self.z_dim == 0:
            return features.new_zeros((B, 1)), features.new_zeros((B,))
        encoded = self.encoder(features, lengths)
        t = torch.arange(T, device=features.device)[None, :, None]
        if getattr(self.args, "sm_reference_pooling", False):
            # the reference max-pools over frames zero-filled up to the
            # batch's longest video (semimarkov_modules.py:843-858), which
            # clamps a shorter video's pooled activations at >= 0; under
            # data parallelism the batch's longest over every rank (JAX's
            # pmax, compound.py:219-221)
            outside = t >= batch_max(shard, lengths.max())
        else:
            outside = t >= lengths[:, None, None]
        pooled = encoded.masked_fill(outside, -float("inf")).amax(dim=1)
        stats = self.encoder_to_params(pooled)
        mean, logvar = stats[:, : self.z_dim], stats[:, self.z_dim :]
        if use_mean:
            z = mean
        else:
            # the single path's draw, this rank's rows of it: a video's noise
            # does not depend on the ranks (JAX folds each video's key with
            # its global index, compound.py:233-237; torch's first rows of a
            # larger draw need not equal a smaller one)
            eps = shard_noise(shard, self._noise(shard.single, generator, features.device))
            z = torch.exp(0.5 * logvar) * eps + mean
        kl = -0.5 * torch.sum(logvar - mean**2 - torch.exp(logvar) + 1.0, dim=1)
        return z, kl

    def _embed(self, name, idx, with_z, z):
        """(B|1, C_sub, E[+Z]) embeddings of the classes `idx`."""
        table = getattr(self, name + "_embeddings").weight
        emb = (self.class_component_matrix @ table)[idx][None]
        if with_z and self.z_dim > 0:
            B, C_sub = z.shape[0], emb.shape[1]
            emb = torch.cat([emb.expand(B, C_sub, emb.shape[-1]),
                             z[:, None, :].expand(B, C_sub, z.shape[-1])], dim=-1)
        return emb

    # ----- factors ------------------------------------------------------

    def compute_potentials(self, features, lengths, vc, constraints_add, end_allowed,
                           generator=None, use_mean_z=True, shard=None):
        """GaussianHsmm.compute_potentials's contract. With z in the
        structure, init, trans and lens are per video; z encodes the RAW
        features, before the flow (the reference sets z before its
        projector runs, semimarkov_modules.py:566-571)."""
        B = features.shape[0]
        C_sub = vc.shape[0]
        pad = vc < 0
        vcs = vc.clamp(min=0)
        mvc = vcs if self.merge_map is None else self.merge_map[vcs]
        feats, log_det = self.project_features(features, lengths)
        z, kl = self._get_z_and_kl(features, lengths, generator, use_mean_z, shard)
        with_z = self.structure_uses_z

        # initial: w . embed(class) (+ class bias), masked log-softmax
        x = self.initial_weights(self._embed("initial", vcs, with_z, z))[..., 0]
        if self.init_dis is not None:
            x = x.masked_fill(self.init_dis[vcs][None], BIG_NEG)
        if self.per_class_bias:
            x = x + self.initial_bias[vcs][None]
        init = torch.log_softmax(x.masked_fill(pad[None], BIG_NEG), dim=-1)

        # transition: f(embed(from)) . embed(to), indexed [to, from]
        tr_emb = self._embed("transition", vcs, with_z, z)
        x = torch.einsum("bfe,bte->btf", self.transition_weights(tr_emb), tr_emb)
        if self.trans_dis is not None:
            x = x.masked_fill(self.trans_dis[vcs][:, vcs][None], BIG_NEG)
        if self.per_class_bias:
            x = x + self.transition_bias[vcs][None, :, None]
        if not self.allow_self_transitions:
            eye = torch.eye(C_sub, dtype=torch.bool, device=x.device)
            x = x.masked_fill(eye[None], BIG_NEG)
        trans = torch.log_softmax(x.masked_fill(pad[None, :, None], BIG_NEG), dim=-2)

        # lengths: MLP(embed(class, merged)) -> log rates
        log_rates = self.length_mlp(self._embed("length", mvc, with_z, z))[..., 0]
        if self.per_class_bias:
            log_rates = log_rates + self.length_bias[vcs][None]
        lens = poisson_length_log_probs(log_rates, self.max_k)  # (B|1, K, C_sub)

        # emission means: MLP(embed(class, merged) ++ z) + bias
        means = self.emission_mean_mlp(self._embed("emission", mvc, True, z))
        means = means + self.emission_mean_bias[None, None, :]
        emit = gaussian_emission_log_probs(feats, means, self.gaussian_cov) + constraints_add
        pots = HsmmPotentials(
            trans=trans.expand(B, C_sub, C_sub),
            init=init.expand(B, C_sub),
            lens=lens.expand((B,) + lens.shape[-2:]),
            emit=emit,
            end_mask=end_allowed,
        )
        return pots, log_det, kl
