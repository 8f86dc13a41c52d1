"""The partition as a ``torch.autograd.Function`` whose forward and
backward are hand-written kernels.

Twin of ``action_segmentation_tpu/ops/hsmm_grad.py``. Training against
the marginal likelihood needs d logZ / d potentials (= posterior expected
sufficient statistics). Autograd of the plain scan (ops/hsmm.py) works
but replays the scan; here:

  * the forward runs the log-semiring scan once over the forward model
    and the time-reversed model stacked on the batch axis
    (``hsmm_log_scan``), and keeps its gamma and alphas planes;
  * the backward runs one band sweep (``hsmm_band_grad``) over the two
    directions' boundary split and forms the cotangents in closed form,
    as JAX's ``_fb_bwd_packed`` does, the transition's pair posteriors
    summed over frames by their own kernel (``hsmm_pair_grad``), which
    holds no (B, T, C, C) exponent, where XLA fuses the same broadcast
    into its sum; it forms only the cotangents that autograd asks for
    (``ctx.needs_input_grad``), so the frame marginals, which ask for d
    logZ / d emit alone, run no pair sum;
  * a call that needs no gradient takes the primal: the forward-only scan
    (``hsmm_forward_scan``) over the forward model alone, as JAX's
    primal calls ``hsmm_alphas_pallas``.

By the HSMM's time symmetry the suffix mass S2[e, c] ("segmentations of
frames [e, L) given the previous span had class c", including the
transition into the first suffix span and the end mask) is the prefix
boundary mass of the REVERSED model. With F[s, c] the prefix mass with
the next span starting at s in class c, the posterior of span (start s,
duration d, class c) is

  exp( F[s,c] + lens[d,c] + (cum[s+d]-cum[s])[c] + S2[s+d,c] - logZ )

from which all five cotangents (emit / trans / init / lens / end_mask)
follow by summation.

Each entry point takes ``kernels``: ``KERNELS`` (the default; the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors) or
``PLAIN`` (the plain versions on any device and dtype, the yardstick the
kernels are held against).

The model's calls (its loss, ``Segmenter.segment_with_marginals``, the
entry point) go through ``centre_emissions``: the DP over emissions
shifted frame by frame to a best class of 0, which float32 needs at the
D=300 emission scale, with the shift's offset added back to logZ.

At every width (K2 log and K1, and above 128 classes the wide scans) the
log scans fold their carry every SCAN_FOLD steps and return each chain's
offsets beside planes relative to them (``hsmm_cuda._scan_plain``): logZ
is the finals' LSE plus the forward chain's offset at the video's last
frame, added in float64, and the backward forms its band inputs and
exponents from float64 pieces anchored per chunk
(``hsmm_cuda._grad_band_inputs``; K4 or its wide kernel reads the same
chunks), so that no float32 value grows with the video's length. Where no
chain folds (up to SCAN_FOLD frames) the backward keeps its float32 form.
The pair sum reads its inputs the same way (``_pair_inputs``): X, Y and Z
= logZ as they are where no chain folds, else X and Y anchored per chunk
as K4's inputs are, with Z = 0.
"""

from typing import Callable, NamedTuple

import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops.hsmm import (
    HsmmPotentials,
    _clamped,
    _durations,
    _emission_cumsum,
    _finals,
)
from action_segmentation_torch.ops.hsmm_cuda import (
    _band_grad_chunked,
    _band_grad_plain,
    _forward_scan_plain,
    _grad_band_inputs,
    _log_scan_plain,
    _pair_grad_plain,
    _stack_fwd_rev,
    chain_offsets,
    hsmm_band_grad,
    hsmm_forward_scan,
    hsmm_log_scan,
    hsmm_pair_grad,
)


class FbKernels(NamedTuple):
    """The four functions the partition's forward and backward call."""

    log_scan: Callable  # (trans, init, dur, emit) -> (gamma, alphas, offsets)
    forward_scan: Callable  # (trans, init, dur, emit) -> (alphas, offsets)
    band_grad: Callable  # (G1m, G2p, dur) -> (qg, sa, st, lg)
    pair_grad: Callable  # (X, Y, trans, Z, lengths) -> the trans cotangent (B, C, C)


KERNELS = FbKernels(hsmm_log_scan, hsmm_forward_scan, hsmm_band_grad, hsmm_pair_grad)
PLAIN = FbKernels(_log_scan_plain, _forward_scan_plain, _band_grad_plain, _pair_grad_plain)


def _log_partition(alphas, offsets, lengths, end_mask):
    """(lse (B,), logZ (B,) float64) of log-scan chains: the LSE of the
    finals (relative to the chain's offset) and that plus the offset at
    each length's last frame. The forward chains with end_mask give the
    partition; the reversed chains of ``_stack_fwd_rev`` with init give
    it too."""
    lse = torch.logsumexp(_finals(alphas, lengths, end_mask), dim=-1)
    return lse, lse.double() + chain_offsets(offsets, lengths - 1)


def _pair_inputs(pots: HsmmPotentials, gb, qg, alphas_f, lse):
    """(X, Y (B, T, C), Z (B,)) of the pair posteriors over the interior
    boundaries s = 1..L-1, exp(X[s, c'] + trans[c, c'] + Y[s, c] - Z): the
    forward mass before s, and Q[s] = LSE_j body, the suffix mass from s
    without the transition. trans stays INSIDE the exponential (the pair
    sum's kernel and plain version add it there): the full exponent is a
    log pair posterior (<= ~0, always representable under BIG_NEG masks),
    while pulling exp(trans) out overflows where a masked transition
    separates a dominant class from the class it cannot reach. Where the
    chains fold X and Y are anchored by the chunk's Fref and cum[t0] as
    K4's inputs are (Z = 0), each formed in float64 and rounded; else X =
    alphas, Y = Q and Z = logZ in float32."""
    B, T, C = pots.emit.shape
    af_sh = torch.cat([alphas_f.new_zeros((B, 1, C)), alphas_f[:, : T - 1]], dim=1)
    if gb.x_shift is None:
        return af_sh, qg - _emission_cumsum(pots.emit)[:, :T], lse
    X = (af_sh.double() + gb.x_shift[..., None]).to(af_sh.dtype)
    Y = (qg.double() - gb.y_shift).to(qg.dtype)
    return X, Y, torch.zeros_like(lse)


def _cotangents(pots: HsmmPotentials, lengths, gamma, offsets, alphas_f, lse, kernels, needs):
    """The cotangents of logZ (B,) (trans, init, lens, emit, end_mask) from
    the forward's planes, each where `needs` asks for it, else None: one
    band sweep where any of the first four is asked for, then the closed
    form of JAX's ``_fb_bwd_packed``, the trans cotangent by
    ``kernels.pair_grad``."""
    B, T, C = pots.emit.shape
    trans_g = init_g = lens_g = emit_g = end_g = None
    if any(needs[:4]):
        gb = _grad_band_inputs(pots, lengths, gamma, offsets, lse)
        qg, sa, st, lg = _band_grad_chunked(kernels.band_grad, gb, T)
        if needs[3]:  # frame marginals from the start/stop difference array
            emit_g = torch.cumsum(sa - st, dim=1)
        if needs[2]:  # rows 1..K-1 are the per-duration posterior masses
            lens_g = torch.cat([lg.new_zeros((B, 1, C)), lg], dim=1)
        if needs[0] or needs[1]:
            X, Y, Z = _pair_inputs(pots, gb, qg, alphas_f, lse)
            if needs[0]:
                trans_g = kernels.pair_grad(X, Y, pots.trans, Z, lengths)
            if needs[1]:
                init_g = torch.exp(pots.init + Y[:, 0] - Z[:, None])
    if needs[4]:
        end_g = torch.exp(_finals(alphas_f, lengths, pots.end_mask) - lse[:, None])
    return trans_g, init_g, lens_g, emit_g, end_g


class HsmmPartitionFB(torch.autograd.Function):
    """logZ (B,) with a kernel forward (the stacked log scan) and a kernel
    backward (the band sweep and the pair sum), which forms only the
    cotangents of the inputs that need a gradient. Inputs as
    ``ops.hsmm.hsmm_partition``; trans/init/lens may be expanded views
    (autograd sums their cotangents back through the expand; the pair
    sum reads an expanded trans in place)."""

    @staticmethod
    def forward(ctx, trans, init, lens, emit, end_mask, lengths, kernels):
        pots = HsmmPotentials(trans, init, lens, emit, end_mask)
        lengths = _clamped(lengths, emit.device)
        gamma, alphas, offsets = kernels.log_scan(*_stack_fwd_rev(pots, lengths))
        B = emit.shape[0]
        alphas_f = alphas[:B]  # the backward reads the forward half
        lse, logZ = _log_partition(alphas_f, offsets[:B], lengths, end_mask)
        ctx.save_for_backward(trans, init, lens, emit, end_mask, lengths, gamma, offsets,
                              alphas_f, lse)
        ctx.kernels = kernels
        return logZ.to(emit.dtype)

    @staticmethod
    def backward(ctx, g):
        trans, init, lens, emit, end_mask, lengths, gamma, offsets, alphas_f, lse = (
            ctx.saved_tensors
        )
        pots = HsmmPotentials(trans, init, lens, emit, end_mask)
        grads = _cotangents(pots, lengths, gamma, offsets, alphas_f, lse, ctx.kernels,
                            ctx.needs_input_grad[:5])
        scales = (g[:, None, None], g[:, None], g[:, None, None], g[:, None, None], g[:, None])
        return (*(None if x is None else x * s for x, s in zip(grads, scales)), None, None)


def _partition_primal(pots: HsmmPotentials, lengths, forward_scan):
    """logZ through the forward-only scan over the forward model (trans
    as given: an expanded table goes to a wide scan once)."""
    lengths = _clamped(lengths, pots.emit.device)
    alphas, offsets = forward_scan(
        pots.trans, pots.init.contiguous(),
        _durations(pots.lens).contiguous(), pots.emit.contiguous(),
    )
    return _log_partition(alphas, offsets, lengths, pots.end_mask)[1].to(pots.emit.dtype)


def hsmm_partition_fb(trans, init, lens, emit, end_mask, lengths, kernels=KERNELS):
    """Log partition (B,), the value of ``ops.hsmm.hsmm_partition``.

    Differentiable through ``HsmmPartitionFB`` when grad mode is on and
    an input requires grad; otherwise the forward-only scan alone."""
    inputs = (trans, init, lens, emit, end_mask)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return HsmmPartitionFB.apply(*inputs, lengths, kernels)
    return _partition_primal(HsmmPotentials(*inputs), lengths, kernels.forward_scan)


def hsmm_partition_fast(pots: HsmmPotentials, lengths, kernels=KERNELS):
    """``hsmm_partition_fb`` taking an HsmmPotentials bundle."""
    return hsmm_partition_fb(
        pots.trans, pots.init, pots.lens, pots.emit, pots.end_mask, lengths, kernels
    )


def centre_emissions(pots: HsmmPotentials, lengths):
    """(centred potentials, offset (B,) float64): each frame's emissions
    shifted down by c[b, t], their max over classes, so that
    logZ(pots) = logZ(centred) + offset with offset = sum_{t < L} c[b, t].

    Every segmentation emits each frame t < L exactly once, so the shift
    moves every path score by the same offset and leaves every posterior
    as it was. It keeps the DP's float32 prefix sums of emissions near the
    best class's: uncentred, D=300 Gaussian emissions (about -500 nats a
    frame) build sums of -5e5 over 1,024 frames, whose ulp (0.03-0.06
    nats) a log posterior, a difference of such sums, inherits.

    c is the max over the entries above BIG_NEG / 2 (0 where a frame has
    none, so a frame masked everywhere stays masked) and 0 from each
    length on (padding never enters the offset). It is detached: its
    exact derivative, sum_c marginal - 1, is zero. trans, init, lens and
    end_mask pass through as given (expanded views stay views); centre
    before ``_stack_fwd_rev`` so that the reversed chain reads the same
    emissions."""
    emit = pots.emit
    lengths = _clamped(lengths, emit.device)
    c = emit.detach().amax(dim=-1)  # a live entry, where there is one, beats a masked one
    t_idx = torch.arange(emit.shape[1], device=emit.device)[None, :]
    c = torch.where((c > BIG_NEG / 2) & (t_idx < lengths[:, None]), c, torch.zeros_like(c))
    return pots._replace(emit=emit - c[:, :, None]), c.double().sum(dim=1)


def hsmm_partition_centred(pots: HsmmPotentials, lengths, partition=hsmm_partition_fast):
    """logZ (B,) of ``partition(pots, lengths)`` (``hsmm_partition_fast``
    or ``ops.hsmm.hsmm_partition``) through ``centre_emissions``: the
    centred DP's logZ plus the offset, added in float64 and rounded once."""
    centred, offset = centre_emissions(pots, lengths)
    return (partition(centred, lengths).double() + offset).to(pots.emit.dtype)


def hsmm_frame_marginals_fast(pots: HsmmPotentials, lengths, kernels=KERNELS):
    """Posterior per-frame class marginals through the forward/backward
    pair: d logZ / d emit[t, c] = E[frame t has class c]; (B, T, C).
    The kernel sibling of ``ops.hsmm.hsmm_frame_marginals``."""
    pots = HsmmPotentials(*(x.detach() for x in pots))
    emit = pots.emit.requires_grad_(True)
    with torch.enable_grad():
        total = hsmm_partition_fast(pots._replace(emit=emit), lengths, kernels).sum()
        return torch.autograd.grad(total, emit)[0]
