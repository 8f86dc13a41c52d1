"""The partition's transition cotangent (ops/hsmm_cuda.py ``hsmm_pair_grad``
and its plain version, ops/hsmm_grad.py ``_cotangents``) against the JAX
package and against the expression it replaces.

On the CPU the wrapper runs ``_pair_grad_plain``; the JAX side runs its
partition as tests/test_torch_hsmm_grad.py does: ``hsmm_partition_fb``
with its Pallas kernels in interpret mode up to 128 classes, and autodiff
of ``ops.hsmm.hsmm_partition`` above (the path JAX trains on there). Same
numpy draws on both sides. Gradients at the JAX package's tolerance (rtol
2e-3 / atol 2e-4, tests/test_hsmm_grad.py); the chunked plain version
against the whole (B, T, C, C) expression bit for bit where one chunk
holds every frame, and at the score tolerance (rtol 1e-5 / atol 1e-4,
tests/test_hsmm_pallas.py) past it, where only the sum's association
differs. The kernels themselves are held against the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py), and the tensor route's
algorithm in float64 on the CPU (tests/test_torch_pair_grad_tc.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_grad as jg
from tests.test_hsmm_grad import random_pots_arrays

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
NAMES = ("trans", "init", "lens", "emit", "end_mask")


def whole_expression(X, Y, trans, Z, lengths):
    """The transition cotangent as the backward formed it before the pair
    sum had a kernel: the whole (B, T, C, C) exponent, masked, then summed
    over frames."""
    T = X.shape[1]
    t_idx = torch.arange(T)[None, :]
    interior = (t_idx >= 1) & (t_idx < lengths[:, None])
    expo = X[:, :, None, :] + trans[:, None, :, :] + Y[:, :, :, None]
    expo = expo - Z[:, None, None, None]
    pair = torch.exp(
        torch.where(interior[:, :, None, None], expo, torch.full_like(expo, BIG_NEG))
    )
    return pair.sum(dim=1)


def draw(seed, B, T, C, K, masked_self=True, end_mask=True, short=True):
    """The JAX gradient test's draw (log-softmax transitions, unit-normal
    durations and emissions), with the self-transitions masked to BIG_NEG
    as the models mask them, a BIG_NEG end mask with one live class a
    video, and ragged lengths down to 1."""
    rng = np.random.RandomState(seed)
    *arrays, lengths = random_pots_arrays(rng, B, T, C, K, constrained=end_mask)
    arrays = [np.array(a) for a in arrays]
    if masked_self:
        arrays[0][:, np.arange(C), np.arange(C)] = BIG_NEG
    lengths = np.array(lengths)
    lengths[0] = T
    if short and B > 1:
        lengths[-1] = 1
    return arrays, lengths


def jax_grads(arrays, lengths, wide):
    """JAX's five cotangents of sum(logZ): its kernel partition in
    interpret mode, or autodiff of its plain partition above 128
    classes."""
    xs = [jnp.asarray(a) for a in arrays]
    L = jnp.asarray(lengths)
    if wide:
        loss = lambda *p: jh.hsmm_partition(jh.HsmmPotentials(*p), L).sum()  # noqa: E731
    else:
        loss = lambda *p: jg.hsmm_partition_fb(*p, L, True).sum()  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*xs)]


def port_grads(arrays, lengths, expand_trans=False, kernels=hg.PLAIN):
    """The port's five cotangents of sum(logZ) through ``kernels``; with
    `expand_trans` the first video's table expanded over the batch, as
    compute_potentials hands it in (its cotangent summed back)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    if expand_trans:
        leaves[0] = torch.from_numpy(arrays[0][0]).requires_grad_(True)
    xs = [leaves[0].expand(arrays[0].shape)] + leaves[1:]
    z = hg.hsmm_partition_fb(*xs, torch.from_numpy(lengths), kernels)
    z.sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("B,T,C,K,end_mask", [
    (3, 20, 5, 6, True),  # T <= SCAN_FOLD: X = alphas, Z = logZ
    (3, 80, 6, 5, True),  # past it: X and Y anchored per chunk, Z = 0
    (4, 40, 19, 8, False),
])
def test_trans_cotangent_matches_jax(B, T, C, K, end_mask):
    arrays, lengths = draw(B * 11 + T, B, T, C, K, end_mask=end_mask)
    want = jax_grads(arrays, lengths, wide=False)
    got = port_grads(arrays, lengths)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("T", [24, 72])
def test_expanded_trans_cotangent_matches_jax(T):
    """One table read by every video: the pair sum reads the expanded view
    in place, and autograd sums its cotangent back through the expand."""
    B, C, K = 3, 5, 4
    arrays, lengths = draw(T, B, T, C, K)
    arrays[0] = np.repeat(arrays[0][:1], B, axis=0)
    want = jax_grads(arrays, lengths, wide=False)
    got = port_grads(arrays, lengths, expand_trans=True)
    np.testing.assert_allclose(got[0], want[0].sum(axis=0), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("T", [16, 70])
def test_wide_trans_cotangent_matches_jax(T):
    """Above 128 classes, against autodiff of JAX's plain partition."""
    B, C, K = 2, 130, 4
    arrays, lengths = draw(C + T, B, T, C, K)
    want = jax_grads(arrays, lengths, wide=True)
    got = port_grads(arrays, lengths)
    np.testing.assert_allclose(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)


def pair_draw(seed, B, T, C, scale=1.0):
    """Pair-sum inputs whose exponents are log pair posteriors at the
    D=300 emission scale (X and Y about -scale * 400 a frame, Z their
    sum's scale), with BIG_NEG transitions on the diagonal, an expanded
    table and ragged lengths down to 1."""
    rng = np.random.RandomState(seed)
    t = np.arange(T, dtype=np.float32)[None, :, None]
    X = (-400.0 * scale * t + rng.randn(B, T, C) * 3).astype(np.float32)
    Y = (-400.0 * scale * (T - t) + rng.randn(B, T, C) * 3).astype(np.float32)
    trans = np.log(rng.dirichlet(np.ones(C), size=C)).astype(np.float32)
    trans[np.arange(C), np.arange(C)] = BIG_NEG
    Z = (-400.0 * scale * T + 3 + rng.randn(B) * 0.1).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    lengths[-1] = 1
    t_ = torch.from_numpy
    return t_(X), t_(Y), t_(trans).expand(B, C, C), t_(Z), t_(lengths)


@pytest.mark.parametrize("T", [1, 17, hc.PAIR_CHUNK])
def test_plain_is_the_whole_expression_within_a_chunk(T):
    inputs = pair_draw(T, 4, T, 7)
    assert torch.equal(hc._pair_grad_plain(*inputs), whole_expression(*inputs))


@pytest.mark.parametrize("T", [hc.PAIR_CHUNK + 1, 3 * hc.PAIR_CHUNK + 5])
def test_plain_sums_its_chunks(T):
    inputs = pair_draw(T, 4, T, 7, scale=0.01)
    torch.testing.assert_close(hc._pair_grad_plain(*inputs), whole_expression(*inputs),
                               rtol=RTOL, atol=ATOL)


def test_plain_holds_one_chunk_of_the_exponent(monkeypatch):
    """No exponentiated tensor of the backward holds more than
    (B, PAIR_CHUNK, C, C) elements, nor B * T * C * C: the whole training
    backward through the wrappers, spied at torch.exp."""
    B, T, C, K = 2, 3 * hc.PAIR_CHUNK + 5, 6, 4
    arrays, lengths = draw(1, B, T, C, K)
    sizes = []
    exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda x: sizes.append(x.numel()) or exp(x))
    port_grads(arrays, lengths, kernels=hg.KERNELS)
    assert max(sizes) == B * hc.PAIR_CHUNK * C * C < B * T * C * C


def spied_pair(calls):
    def pair_grad(*args):
        calls.append(args[2].shape)
        return hc._pair_grad_plain(*args)
    return hg.PLAIN._replace(pair_grad=pair_grad)


def test_training_backward_sums_the_pairs_once_and_marginals_never():
    B, T, C, K = 3, 70, 5, 4
    arrays, lengths = draw(4, B, T, C, K)
    calls = []
    port_grads(arrays, lengths, kernels=spied_pair(calls))
    assert calls == [(B, C, C)]
    pots = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    L = torch.from_numpy(lengths)
    marg = hg.hsmm_frame_marginals_fast(pots, L, spied_pair(calls))
    assert calls == [(B, C, C)]
    torch.testing.assert_close(marg, hg.hsmm_frame_marginals_fast(pots, L, hg.PLAIN),
                               rtol=0, atol=0)
    torch.testing.assert_close(marg, th.hsmm_frame_marginals(pots, L), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("asked", [(0,), (1,), (0, 3), (2, 4)])
def test_backward_forms_what_is_asked(asked):
    """Only the inputs that need a gradient get one, each equal to the
    same cotangent with all five asked for; the pair sum runs only for
    trans."""
    B, T, C, K = 3, 24, 5, 4
    arrays, lengths = draw(9, B, T, C, K)
    want = port_grads(arrays, lengths)
    xs = [torch.from_numpy(a).requires_grad_(k in asked) for k, a in enumerate(arrays)]
    calls = []
    hg.hsmm_partition_fb(*xs, torch.from_numpy(lengths), spied_pair(calls)).sum().backward()
    assert len(calls) == int(0 in asked)
    for k, (x, w) in enumerate(zip(xs, want)):
        if k in asked:
            assert np.array_equal(x.grad.numpy(), w), NAMES[k]
        else:
            assert x.grad is None, NAMES[k]


@pytest.mark.parametrize("B,T,C,runs,frames", [
    (18, 1024, 19, 29, 36),  # the serving shape, the scalar route: 522 blocks for 528 slots
    (18, 1024, 342, 2, 512),  # the S6 shape: 1,296 blocks of 64 x 64 pairs
    (18, 1024, 1577, 1, 1024),  # every CrossTask task
    (1, 1024, 1577, 1, 1024),
    (4, 1024, 128, 8, 128),
    (2, 12000, 19, 261, 46),
    (3, 7, 19, 1, 7),
    (18, 49, 12, 1, 49),
])
def test_pair_grad_tile(B, T, C, runs, frames):
    tile = hc.pair_grad_tile(B, T, C)
    assert (tile.runs, tile.frames) == (runs, frames)
    scalar = C <= hc.PAIR_NARROW_CLASSES
    assert tile.route == ("scalar" if scalar else "tensor")
    side = hc.PAIR_SCALAR_TILE if scalar else hc.PAIR_TILE
    assert tile.tiles == (-(-C // side)) ** 2 and tile.blocks_per_sm == (4 if scalar else 2)
    # every frame in one run, every run past the first frame's
    assert (tile.runs - 1) * tile.frames < T <= tile.runs * tile.frames
    # runs of at least one staged pass, partials within two (B, T, C) planes
    assert tile.runs == 1 or (tile.frames >= hc.PAIR_FRAMES and tile.runs * C <= T)
    word = 4 if scalar else 8
    assert tile.scratch_bytes == (word * B * tile.runs * C * C if tile.runs > 1 else 0)
    assert tile.waves == -(-B * tile.tiles * tile.runs // (132 * tile.blocks_per_sm))


def test_pair_grad_tile_on_the_tensor_route_at_narrow_widths():
    """Asked for, the tensor route takes any C, tiles of 64 a side."""
    tile = hc.pair_grad_tile(18, 1024, 19, route="tensor")
    assert (tile.route, tile.tiles, tile.blocks_per_sm, tile.runs, tile.frames) == (
        "tensor", 1, 2, 14, 74)


def test_pair_kernel_shared_memory_fits_two_blocks_an_sm():
    assert 2 * (hc.PAIR_SMEM + hc.SM_SMEM_PER_BLOCK) <= hc.SM_SMEM
    assert hc.PAIR_SMEM <= hc.MAX_BLOCK_SMEM


def test_pair_grad_wrapper_takes_cpu_or_cuda_only():
    """CPU tensors run the plain version and count no launch; a tensor on
    another device raises."""
    inputs = pair_draw(2, 3, 10, 4)
    before = hc.hsmm_pair_grad.launches
    assert torch.equal(hc.hsmm_pair_grad(*inputs), hc._pair_grad_plain(*inputs))
    assert hc.hsmm_pair_grad.launches == before
    meta = [x.to("meta") for x in inputs]
    with pytest.raises(ValueError, match="meta"):
        hc.hsmm_pair_grad(*meta)


def test_narrow_pair_grad_wrapper_takes_cpu_or_cuda_only():
    """The scalar route's wrapper alike."""
    inputs = pair_draw(3, 3, 10, 4)
    before = hc.hsmm_pair_grad_narrow.launches
    assert torch.equal(hc.hsmm_pair_grad_narrow(*inputs), hc._pair_grad_plain(*inputs))
    assert hc.hsmm_pair_grad_narrow.launches == before
    with pytest.raises(ValueError, match="meta"):
        hc.hsmm_pair_grad_narrow(*[x.to("meta") for x in inputs])
