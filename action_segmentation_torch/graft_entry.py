"""The port's entry points: the flagship forward step and the multi-rank
dry run.

Twin of ``__graft_entry__.py``. ``entry`` gives the forward step of the
flagship Gaussian HSMM (potentials and the log partition through the
kernels on the card, K1 without a gradient) at C, D, B, T = 12, 64, 4,
96. ``dryrun_multichip(n)`` spawns n ranks of one gloo group
(``parallel.mesh.run_ranks``; on the card unless the caller asks for the
CPU, the ranks sharing it) and runs the JAX dry run's five stages
on them: the Gaussian model's full training step, supervised and
unsupervised, and the data-parallel decode; the compound model's step
with its latent; the constrained (U7-style) step and decode; the
resident epoch through ``SemiMarkovModel.fit`` and ``predict``; and the
accumulated gradient against the whole batch's. Each stage checks finite
losses, valid labels and every rank's parameters bit-equal to rank 0's,
and prints one ``dryrun stage '...' OK`` line; a rank's failure is the
dry run's.

    python -m action_segmentation_torch.graft_entry [n_ranks] [--device cpu]
"""

import argparse

import numpy as np
import torch

from action_segmentation_torch import BIG_NEG, resolve_device


def _args(compound=False, **overrides):
    from action_segmentation_torch.models.base import add_training_args
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    parser = argparse.ArgumentParser()
    SemiMarkovModel.add_args(parser)
    add_training_args(parser)
    parser.add_argument("--batch_size", type=int, default=10)
    args = parser.parse_args([])
    if compound:
        args.sm_component_model = True
        args.sm_component_embedding_dim = 16
        args.sm_component_z_dim = 4
        args.sm_component_z_hidden_dim = 16
        args.seq_num_layers_component = 1
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def _make_module(C=12, D=64, seed=0, compound=False, device=None, **structure):
    """The flagship Gaussian HSMM (its means drawn at scale 0.1 from
    `seed`) or, with `compound`, the compound model with a 4-wide latent."""
    from action_segmentation_torch.models.semimarkov import GaussianHsmm

    device = resolve_device(device)
    args = _args(compound)
    if compound:
        from action_segmentation_torch.models.compound import ComponentHsmm

        return ComponentHsmm(args, C, n_components=C,
                             class_to_components={c: {c} for c in range(C)},
                             feature_dim=D, allow_self_transitions=True, seed=seed,
                             device=device)
    module = GaussianHsmm(args, C, D, allow_self_transitions=True, seed=seed, device=device,
                          **structure)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        module.gaussian_means.copy_(torch.randn(C, D, generator=gen) * 0.1)
    return module


def entry(device=None):
    """(fn, example_args): the forward step of the flagship model,
    ``fn(*example_args)`` -> logZ + log_det (B,). It builds the HSMM
    potentials (masked softmaxes, Poisson durations, the batched Gaussian
    emission matmul) and runs the log-semiring scan over the emissions
    centred frame by frame (``ops.hsmm_grad.hsmm_partition_centred``) to the
    marginal log-likelihood: the forward-only scan kernel (K1) on the card, its
    plain version on the CPU. example_args[0] is the module, whose weights
    a caller may replace (``bridge.gaussian_hsmm_params_from_numpy``)."""
    from action_segmentation_torch.ops.hsmm_grad import hsmm_partition_centred

    device = resolve_device(device)
    C, D, B, T = 12, 64, 4, 96
    module = _make_module(C, D, device=device)
    rng = np.random.RandomState(0)
    features = torch.as_tensor(rng.randn(B, T, D).astype(np.float32), device=device)
    lengths = torch.full((B,), T, dtype=torch.long, device=device)
    vc = torch.arange(C, device=device)
    cons = torch.zeros((B, T, C), device=device)
    end_allowed = torch.zeros((B, C), device=device)

    @torch.no_grad()
    def forward(module, features, lengths, vc, cons, end_allowed):
        pots, log_det, _ = module.compute_potentials(
            features, lengths, vc, cons, end_allowed, use_mean_z=True)
        return hsmm_partition_centred(pots, lengths) + log_det

    return forward, (module, features, lengths, vc, cons, end_allowed)


class _Batch:
    """One host batch of the dry run (numpy), whole; ``local`` gives a
    rank's rows on its device and its Shard."""

    def __init__(self, features, lengths, gt, cons, end_allowed, C):
        self.arrays = (features, lengths, gt, cons, end_allowed)
        self.C = C
        self.B = len(lengths)

    def local(self, mesh, lo=0, hi=None):
        from action_segmentation_torch.parallel.mesh import (
            Shard,
            pad_batch_for_mesh,
            shard_rows,
        )

        arrays = [a[lo:hi] for a in self.arrays]
        B = len(arrays[1])
        padded, weights = pad_batch_for_mesh(mesh, arrays, B, pad_to=B)
        f, le, gt, cons, end, w = (torch.as_tensor(shard_rows(mesh, x), device=mesh.device)
                                   for x in (*padded, weights))
        vc = torch.arange(self.C, device=mesh.device)
        shard = Shard(mesh, len(padded[1]), B)
        return (f, le, vc, vc, gt, cons, end, w), shard, B


def _grads(model, batch, mesh, use_labels, lo=0, hi=None, generator=None):
    """The batch's (rows lo:hi) global loss; its gradients, summed over
    the ranks, replace the parameters' .grad."""
    from action_segmentation_torch.parallel.mesh import (
        all_reduce_grads,
        reduce_terms,
        terms_to_loss_aux,
    )

    args, shard, B = batch.local(mesh, lo, hi)
    for p in model.module.parameters():
        p.grad = None
    loss, aux = model._loss(*args, use_labels=use_labels, generator=generator, denom=B,
                            shard=shard)
    loss.backward()
    all_reduce_grads(mesh, list(model.module.parameters()))
    terms = reduce_terms(mesh, aux["terms"].clone())
    total, _ = terms_to_loss_aux(terms, torch.tensor(float(B), device=mesh.device),
                                 use_labels)
    return float(total)


def _step(model, batch, mesh, use_labels, generator=None):
    """One full training step (loss, the summed gradients, mask, clip,
    Adam); returns (loss, the global gradient norm)."""
    from action_segmentation_torch.models.base import clip_grads, make_optimizer, mask_grads

    named = list(model.module.named_parameters())
    params = [p for _, p in named]
    optimizer, _ = make_optimizer(model.args, params)
    loss = _grads(model, batch, mesh, use_labels, generator=generator)
    mask_grads(named, model.module.trainable_mask)
    gnorm = float(clip_grads(params, model.args.max_grad_norm))
    optimizer.step()
    return loss, gnorm


def _decode(model, batch, mesh):
    """The batch's labels (B, T) on every rank, each rank decoding its rows."""
    from action_segmentation_torch.parallel.mesh import combine_rows

    (f, le, vc, _, _, cons, end, _), shard, B = batch.local(mesh)
    labels, scores = model._decode(f, le, vc, cons, end, shard)
    if not torch.isfinite(scores).all():
        raise RuntimeError("non-finite decode scores")
    return combine_rows(mesh, labels, shard.padded)[:B].cpu().numpy()


def _check(cond, msg):
    if not cond:
        raise RuntimeError("dryrun " + msg)


def _same_replicas(stage, mesh, module):
    from action_segmentation_torch.parallel.mesh import replicas_differ

    differ = replicas_differ(mesh, module)
    _check(not differ, "stage '{}': rank {} parameters differ from rank 0's: {}".format(
        stage, mesh.rank, differ))


# the kernels' wrappers whose launches a rank of the dry run reports
KERNEL_WRAPPERS = ("hsmm_gamma_scan", "hsmm_band_max", "hsmm_log_scan", "hsmm_forward_scan",
                   "hsmm_band_grad", "hsmm_pair_grad", "hsmm_pair_grad_narrow",
                   "hsmm_viterbi_scan", "hsmm_viterbi_traceback")


def _dryrun_rank(mesh, n_devices):
    """The five stages on this rank; returns its stage lines, losses and
    the kernels' launches (by wrapper name; the plain versions on the CPU
    count none)."""
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.base import batch_generator
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops import hsmm_cuda
    from action_segmentation_torch.parallel.mesh import replicate_module

    for name in KERNEL_WRAPPERS:
        getattr(hsmm_cuda, name).launches = 0
    device = mesh.device
    C, D, T = 12, 32, 64
    B = max(n_devices, 2) * 2  # divisible by the world and, halved, again
    lines, losses = [], {}
    rng = np.random.RandomState(0)
    features = rng.randn(B, T, D).astype(np.float32)
    lengths = np.full(B, T, np.int64)
    gt = rng.randint(0, C, size=(B, T)).astype(np.int64)
    batch = _Batch(features, lengths, gt, np.zeros((B, T, C), np.float32),
                   np.zeros((B, C), np.float32), C)

    def model_of(module, compound=False):
        replicate_module(mesh, module)
        return SemiMarkovModel(_args(compound), C, D, module, device)

    # 1. the Gaussian model's full step, supervised and unsupervised; decode
    for use_labels in (True, False):
        model = model_of(_make_module(C, D, device=device))
        loss, _ = _step(model, batch, mesh, use_labels)
        _check(np.isfinite(loss), "data-parallel use_labels={}: loss {}".format(
            use_labels, loss))
        losses["data-parallel {}".format(use_labels)] = loss
        _same_replicas("data-parallel", mesh, model.module)
    labels = _decode(model, batch, mesh)
    _check(((labels >= 0) & (labels < C)).all(), "data-parallel decode: invalid labels")
    lines.append("dryrun stage 'data-parallel' OK: {} ranks (data={}, model=1) on {}".format(
        n_devices, n_devices, device))

    # 2. the compound model's unsupervised step, its latent drawn
    model = model_of(_make_module(C, D, compound=True, device=device), compound=True)
    loss, _ = _step(model, batch, mesh, False, generator=batch_generator(0, 0, 0, device))
    _check(np.isfinite(loss), "compound stage: loss {}".format(loss))
    _same_replicas("compound (VAE z)", mesh, model.module)
    losses["compound"] = loss
    lines.append("dryrun stage 'compound (VAE z)' OK: {} ranks".format(n_devices))

    # 3. the constrained (U7-style) step and decode: canonical order with
    # merged backgrounds, narration penalties, allowed ends
    order = list(range(0, C, 2))
    allowed_transitions = {}
    for a, b in zip(order, order[1:]):
        allowed_transitions.setdefault(a, set()).update({b, 1})
        allowed_transitions.setdefault(1, set()).add(b)
    allowed_ends = {order[-1], 1}
    for src in range(C):
        allowed_transitions.setdefault(src, set()).add(src)
    module = _make_module(
        C, D, device=device, allowed_starts={order[0], 1},
        allowed_transitions=allowed_transitions, allowed_ends=allowed_ends,
        merge_classes={c: (1 if c % 2 == 1 else c) for c in range(C)})
    model = model_of(module)
    ncons = ((rng.rand(B, T, C) < 0.3) * -1e4).astype(np.float32)
    ends = np.where(np.array([[c in allowed_ends for c in range(C)]] * B), 0.0,
                    BIG_NEG).astype(np.float32)
    constrained = _Batch(features, lengths, gt, ncons, ends, C)
    loss, gnorm = _step(model, constrained, mesh, False)
    _check(np.isfinite(loss) and np.isfinite(gnorm),
           "constrained stage: loss {}, |GParam| {}".format(loss, gnorm))
    _check(all(torch.isfinite(p).all() for p in model.module.parameters()),
           "constrained stage: non-finite parameters")
    _same_replicas("constrained (U7-style)", mesh, model.module)
    labels = _decode(model, constrained, mesh)
    _check(((labels >= 0) & (labels < C)).all(), "constrained decode: invalid labels")
    losses["constrained"] = loss
    lines.append("dryrun stage 'constrained (U7-style)' OK: {} ranks".format(n_devices))

    # 4. the resident epoch through fit and predict, a partial last batch
    train = SyntheticDatasplit(num_videos=2 * B + 1, n_classes=3, max_len=T, span_k=4,
                               feature_dim=D, seed=0)
    fargs = _args(sm_max_span_length=8, epochs=1, lr=5e-3, batch_size=B, data_parallel=True)
    model = SemiMarkovModel.from_args(fargs, train, device=device)
    epoch = []
    model.fit(train, use_labels=False, callback_fn=lambda e, s: epoch.append(s["train_loss"]))
    _check(model._get_resident(train, False) is not None, "resident stage: no resident corpus")
    _check(len(epoch) == 1 and np.isfinite(epoch[0]), "resident stage: losses {}".format(epoch))
    _same_replicas("resident epoch", mesh, model.module)
    predictions = model.predict(train)
    _check(len(predictions) == 2 * B + 1 and all(
        ((p >= 0) & (p < 3)).all() for p in predictions.values()),
        "resident stage: invalid predictions")
    losses["resident"] = epoch[0]
    lines.append("dryrun stage 'resident epoch' OK: {} ranks".format(n_devices))

    # 5. the accumulated gradient of two half batches against the whole's
    model = model_of(_make_module(C, D, device=device))
    params = list(model.module.parameters())
    half = B // 2
    acc = 0.0
    for lo in (0, half):
        _grads(model, batch, mesh, False, lo, lo + half)
        acc = acc + torch.cat([p.grad.reshape(-1) for p in params])
    acc = acc / 2.0
    _grads(model, batch, mesh, False)
    full = torch.cat([p.grad.reshape(-1) for p in params])
    _check(torch.isfinite(acc).all(), "accumulation stage: non-finite gradients")
    cos = float(acc @ full / torch.clamp(acc.norm() * full.norm(), min=1e-30))
    _check(cos > 0.5, "accumulation stage: the accumulated gradient disagrees with the "
           "whole batch's (cos={:.3f})".format(cos))
    lines.append("dryrun stage 'dp accumulation' OK: {} ranks (cos={:.3f})".format(
        n_devices, cos))
    return lines, losses, {name: getattr(hsmm_cuda, name).launches for name in KERNEL_WRAPPERS}


def dryrun_multichip(n_devices, device=None):
    """The five data-parallel stages on `n_devices` spawned gloo ranks, each
    rank's tensors on `device` (None: the card; raises without one). Prints rank 0's stage
    lines; every rank must report the same losses. Raises if a rank
    fails. Returns {"losses": rank 0's by stage, "launches": each rank's
    kernel launches}."""
    from action_segmentation_torch.parallel.mesh import run_ranks

    out = run_ranks(_dryrun_rank, n_devices, n_devices, device=resolve_device(device))
    for line in out[0][0]:
        print(line, flush=True)
    for rank, (_, losses, _) in enumerate(out):
        _check(losses == out[0][1], "rank {} losses {} != rank 0's {}".format(
            rank, losses, out[0][1]))
    print("dryrun_multichip OK: {} ranks, losses finite and equal on every rank".format(
        n_devices), flush=True)
    return {"losses": out[0][1], "launches": [launches for _, _, launches in out]}


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("n_ranks", type=int, nargs="?", default=2)
    cli.add_argument("--device", default=None, help="each rank's device (default: the card)")
    opts = cli.parse_args()
    fn, example = entry(opts.device)
    print("entry forward:", fn(*example).cpu().numpy())
    dryrun_multichip(opts.n_ranks, opts.device)
