"""A DP wider than 128 classes on the CPU, against the JAX package.

Above 128 classes the JAX package runs its jnp DPs (ops/hsmm.py: the
Viterbi keeps bp_d and bp_c in two planes, the partition and the
marginals by autograd). The port packs a wide DP's backpointer codes at
``hsmm_cuda.code_radix(C)`` (1024 up to 1,024 classes, not the narrow
kernels' 128, which a class index >= 128 would carry into the duration;
past 1,024 the least power of two >= C, 2048 at 1,577 classes), and its
wrappers run their kernels' plain versions on CPU tensors. Same
numpy inputs on both sides. Tolerances are the JAX package's: scores
and logZ rtol 1e-5 / atol 1e-4 (tests/test_hsmm_pallas.py), gradients
and marginals rtol 2e-3 / atol 2e-4 (tests/test_hsmm_grad.py); spans and
labels equal. The launch rules of the wide kernels are checked against
an H100 block's limits; the kernels themselves run on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 4i).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.api import Segmenter as TSegmenter
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_tpu.api import Segmenter as JSegmenter
from action_segmentation_tpu.ops import hsmm as jh
from tests.conftest import make_sm_args
from tests.test_hsmm_grad import random_pots_arrays
from tests.test_torch_semimarkov import fitted

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
NAMES = ("trans", "init", "lens", "emit", "end_mask")
WIDE_KERNELS = (hc.hsmm_viterbi_scan_wide, hc.hsmm_viterbi_traceback_wide,
                hc.hsmm_log_scan_wide, hc.hsmm_forward_scan_wide)


def past_radix(C):
    """The first class index past the radix below ``code_radix(C)``: 128
    (the narrow radix) up to 1,024 classes, 1,024 past them."""
    return 128 if C <= 1024 else 1024


def wide_arrays(rng, B, T, C, K):
    """Potentials whose best paths visit the classes at and above
    ``past_radix(C)``: their emissions get a bonus, so that a code's class
    index past the narrow radix (past 1,024 classes: past the radix of
    1,024 classes) is read on the walk. (arrays, lengths ragged down to
    1)."""
    trans = rng.randn(B, C, C).astype(np.float32)
    init = rng.randn(B, C).astype(np.float32)
    lens = rng.randn(B, K, C).astype(np.float32)
    lens[:, 0] = -1e9
    emit = rng.randn(B, T, C).astype(np.float32)
    emit[:, :, past_radix(C):] += 1.5
    end_mask = np.zeros((B, C), np.float32)
    lengths = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 1
    return (trans, init, lens, emit, end_mask), lengths


@pytest.mark.parametrize("C", (129, 200, 342, 1100, 1577))
def test_wide_viterbi_spans_match_jax(C):
    """``hsmm_viterbi_spans`` (the plain scan and traceback at the wide
    radix) against JAX's jnp ``hsmm_viterbi``: spans equal, the walk
    reading classes past 127 (past 1,023 above 1,024 classes)."""
    arrays, lengths = wide_arrays(np.random.RandomState(C), 3, 24, C, 8)
    want_spans, want_scores = jh.hsmm_viterbi(
        jh.HsmmPotentials(*map(jnp.asarray, arrays)), jnp.asarray(lengths))
    before = [k.launches for k in WIDE_KERNELS]
    got_spans, got_scores = hc.hsmm_viterbi_spans(
        th.HsmmPotentials(*map(torch.from_numpy, arrays)), torch.from_numpy(lengths))
    assert [k.launches for k in WIDE_KERNELS] == before  # plain versions on the CPU
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_spans.numpy(), np.asarray(want_spans))
    assert (got_spans.numpy() >= past_radix(C)).any()  # the walk read a class past the radix


def test_code_radix_and_its_overflow():
    """128 at the narrow widths (the narrow kernels' compiled radix), 1024
    over the wide kernels' range, a power of two >= C past it; a band
    whose codes would pass int32 is refused."""
    assert [hc.code_radix(C) for C in (1, 128, 129, 342, 1024, 1025, 3000)] == [
        128, 128, 1024, 1024, 1024, 2048, 4096]
    z = torch.zeros
    band = z(1, 1, 200).expand(1, 2 ** 21 + 1, 200)  # a view: no memory
    with pytest.raises(ValueError, match="overflow"):
        hc.hsmm_viterbi_scan(z(1, 200, 200), z(1, 200), band, z(1, 0, 200))


@pytest.fixture(scope="module")
def wide_model():
    """A closed-form 160-class synthetic model (JAX's and the port's)."""
    args = make_sm_args(sm_max_span_length=20, sm_supervised_method="closed-form")
    return fitted(args, n_classes=160)


@pytest.mark.parametrize("order", ["default", "reversed"])
def test_wide_segmenter_matches_jax(wide_model, order):
    """``Segmenter`` over every class of a 160-class model, in the model's
    order and reversed (a DP index is then 159 - class, so the frequent
    low classes sit past index 127): labels equal to JAX's Segmenter."""
    jm, tm, _, ttest = wide_model
    valid = None if order == "default" else np.arange(160)[::-1]
    feats = [ttest._samples[name]["features"] for name in sorted(ttest._samples)]
    want = JSegmenter(jm, valid_classes=valid).segment_many(feats, batch_size=5)
    got = TSegmenter(tm, valid_classes=valid).segment_many(feats, batch_size=5)
    for f, g, w in zip(feats, got, want):
        assert g.shape == (f.shape[0],)
        np.testing.assert_array_equal(g, w)


def test_wide_segment_with_marginals_matches_jax(wide_model):
    """``segment_with_marginals`` at 160 classes: labels equal to JAX's,
    marginals at the gradient tolerance."""
    jm, tm, _, ttest = wide_model
    features = ttest._samples[sorted(ttest._samples)[0]]["features"]
    want_labels, want = JSegmenter(jm).segment_with_marginals(features)
    got_labels, got = TSegmenter(tm).segment_with_marginals(features)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got.shape == want.shape == (features.shape[0], 160)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("C", (160, 200, 1100))
def test_wide_partition_fb_plain_matches_jax(C):
    """``HsmmPartitionFB`` through the PLAIN kernels (the card route's
    twin: the stacked log scan, the band sweep) against autograd of JAX's
    jnp ``hsmm_partition``: logZ and the five gradients."""
    arrays = [np.array(a) for a in random_pots_arrays(
        np.random.RandomState(C), 2, 12, C, 5)]
    arrays, lengths = arrays[:5], arrays[5]
    xs = [jnp.asarray(a) for a in arrays]

    def total(*xs):
        return jh.hsmm_partition(jh.HsmmPotentials(*xs), jnp.asarray(lengths)).sum()

    want_z = jh.hsmm_partition(jh.HsmmPotentials(*xs), jnp.asarray(lengths))
    want = jax.grad(total, argnums=(0, 1, 2, 3, 4))(*xs)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    z = hg.hsmm_partition_fb(*ts, torch.from_numpy(lengths), kernels=hg.PLAIN)
    z.sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z), rtol=RTOL, atol=ATOL)
    for name, t, w in zip(NAMES, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_kernel_path_on_the_card_takes_wide_dps():
    """On the card a DP of any width above 128 classes takes the kernels
    (the spans chain above 128 model classes, the kernel partition):
    1,025, the 1,577 of all 83 CrossTask tasks and 4,096 as 342 do."""
    cuda = torch.device("cuda")  # a device type: nothing runs
    for width in (129, 342, 1024, 1025, 1577, 4096):
        assert hc.kernel_path(342 if width <= 342 else width, width, cuda) == ("spans", "kernels")
    assert hc.kernel_path(128, 128, cuda) == ("labels", "kernels")


@pytest.fixture(scope="module")
def model_past_1024():
    """A 1,100-class model (JAX's and the port's) with the same seeded
    random parameters on both sides (a closed-form fit on the synthetic
    corpus sees its first classes only), and test videos drawn from its
    classes' means, a third of their spans in the classes past 1,023."""
    C, D = 1100, 16
    args = make_sm_args(sm_max_span_length=6, sm_supervised_method="closed-form")
    jm, tm, _, _ = fitted(args, n_classes=C, feature_dim=D, n_train=4, n_test=1, max_len=12)
    rng = np.random.RandomState(1100)
    params = {"gaussian_means": 3 * rng.randn(C, D), "gaussian_cov": np.ones(D),
              "transition_logits": rng.randn(C, C), "init_logits": rng.randn(C),
              "poisson_log_rates": np.log(1 + 4 * rng.rand(C))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jm.module.params = {k: jnp.asarray(v) for k, v in params.items()}
    tm.module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    feats = []
    for length in (20, 13, 1, 17):
        labels = []
        while len(labels) < length:
            cls = rng.randint(1024, C) if rng.rand() < 1 / 3 else rng.randint(0, 1024)
            labels += [cls] * rng.randint(1, 5)
        means = params["gaussian_means"][labels[:length]]
        feats.append((means + 0.3 * rng.randn(length, D)).astype(np.float32))
    return jm, tm, feats


def test_wide_segmenter_past_1024_classes_matches_jax(model_past_1024):
    """``Segmenter.segment_many`` over every class of a 1,100-class model
    (a DP whose codes are at radix 2,048): labels equal to JAX's
    Segmenter, classes past 1,023 among them."""
    jm, tm, feats = model_past_1024
    want = JSegmenter(jm).segment_many(feats, batch_size=2)
    got = TSegmenter(tm).segment_many(feats, batch_size=2)
    for f, g, w in zip(feats, got, want):
        assert g.shape == (f.shape[0],)
        np.testing.assert_array_equal(g, w)
    assert max(int(g.max()) for g in got) >= 1024


WIDE_CLASSES = (129, 342, 1024, 1025, 1577, 2048)
WIDE_KMS = (1, 19, 64, 100)


@pytest.mark.parametrize("C", WIDE_CLASSES)
@pytest.mark.parametrize("Km", WIDE_KMS)
def test_wide_scan_launch_fits_the_block(C, Km):
    """csrc/hsmm_scan_wide.cu's launch (``wide_scan_instance``) for 18
    chains of one expanded table. On the cluster route: at most 8 blocks a
    chain, each of at most 256 threads (its slab of classes in whole
    warps), the slabs covering C with none empty, and a block's alpha
    rows, table columns and ring within 232,448 bytes. On the grid route:
    at most one block an SM, the slabs and chain groups covering C and the
    18 chains with none empty, a block's pairs in whole warps up to
    GRID_THREADS (each thread then its pairs in turn), and its table slab,
    alpha rows, each pair's prefix sum and duration argmax and, where they
    fit, its ring rows within a block's shared memory."""
    inst = hc.wide_scan_instance(C, Km, 18, 18)
    assert inst.smem_bytes <= hc.MAX_BLOCK_SMEM
    if inst.route == "cluster":
        assert 1 <= inst.cluster <= hc.WIDE_MAX_CLUSTER and inst.ring == "shared"
        assert (inst.cluster - 1) * inst.slab < C <= inst.cluster * inst.slab
        assert inst.threads == 32 * -(-inst.slab // 32) <= hc.WIDE_SLAB_THREADS
        assert inst.smem_bytes == hc.wide_cluster_smem(C, Km, inst.slab)
        assert inst.smem_bytes >= 4 * (2 * C + min(inst.slab, C) * C + Km * inst.slab)
    else:
        assert inst.route == "grid" and inst.cluster == 0 and inst.launch_chains == 18
        slabs, groups = -(-C // inst.slab), -(-18 // inst.chains)
        assert (slabs - 1) * inst.slab < C and (groups - 1) * inst.chains < 18
        assert inst.blocks == slabs * groups <= hc.H100_SMS
        pairs = inst.chains * inst.slab
        assert inst.threads == min(hc.GRID_THREADS, 32 * -(-pairs // 32))
        assert inst.smem_bytes == hc.wide_grid_smem(C, Km, inst.slab, inst.chains, inst.table,
                                                    inst.ring)
        assert inst.smem_bytes >= 4 * (inst.chains * C + 2 * pairs
                                       + inst.slab * C * (inst.table == "shared")
                                       + Km * pairs * (inst.ring == "shared"))
    # the serving width's table over 3 blocks (Km = 19 at C = 342), and
    # 1,577 classes on the grid route at Km = 64 (the ring past a block's
    # shared memory beside the table slab) and at Km = 19 (the ring in it)
    assert hc.wide_scan_instance(342, 19)[:2] == ("cluster", 3)
    assert hc.wide_scan_instance(1577, 64, 18, 18)[::6] == ("grid", "shared")
    assert hc.wide_scan_instance(1577, 64, 18, 18).ring == "global"
    assert hc.wide_scan_instance(1577, 19, 18, 18).ring == "shared"


@pytest.mark.parametrize("C", (200, 700))
@pytest.mark.parametrize("B", (1, 3))
def test_grouped_stack_plain_equals_concatenated(C, B):
    """Above 128 classes a model's expanded table stacks as two tables
    (the table and its transpose, a (2, B, C, C) view read by B chains
    each): the plain scans' outputs on it are the concatenated form's
    (a table a chain), bit for bit."""
    rng = np.random.RandomState(C + B)
    arrays, lengths = wide_arrays(rng, B, 12, C, 6)
    pots = th.HsmmPotentials(*map(torch.from_numpy, arrays))
    pots = pots._replace(trans=pots.trans[:1].expand(B, C, C))
    L = torch.from_numpy(lengths).long()
    grouped = hc._stack_fwd_rev(pots, L)
    assert tuple(grouped[0].shape) == (2, B, C, C) and (B == 1 or grouped[0].stride(1) == 0)
    dense = hc._dense_trans(grouped[0])
    table = pots.trans[0]
    assert torch.equal(dense, torch.cat([table.expand(B, C, C),
                                         table.T.expand(B, C, C)]))
    concat = (dense.contiguous(), *grouped[1:])
    for fn in (hc._log_scan_plain, hc._viterbi_scan_plain):
        for got, want in zip(fn(*grouped), fn(*concat)):
            assert torch.equal(got, want), fn.__name__
    for got, want in zip(hc._forward_scan_plain(*hc._forward_chains(grouped, B)),
                         hc._forward_scan_plain(*hc._forward_chains(concat, B))):
        assert torch.equal(got, want)
    assert torch.equal(hc._forward_chains(grouped, B)[0], pots.trans)
    # at <= 128 classes, or a table a video, the stack stays concatenated
    narrow = th.HsmmPotentials(*(x[..., :100, :100] if x.dim() == 3 and x.shape[-2] == C
                                 else x[..., :100] for x in pots))
    assert hc._stack_fwd_rev(narrow, L)[0].dim() == 3
    if B > 1:
        assert hc._stack_fwd_rev(pots._replace(trans=pots.trans.contiguous()), L)[0].dim() == 3


@pytest.mark.parametrize("C", (700, 1100))
def test_wide_frame_marginals_grouped_match_jax(C):
    """The port's frame marginals (``hsmm_frame_marginals_fast`` through
    the PLAIN Function: the stacked log scan on the two grouped tables, the
    band sweep) against JAX's ``hsmm_frame_marginals`` (autograd of its jnp
    partition) on two short videos with an expanded transition view."""
    rng = np.random.RandomState(C)
    B, T, K = 2, 20, 5
    arrays = [np.array(a) for a in random_pots_arrays(rng, 1, T, C, K)][:5]
    arrays = [np.repeat(a, B, axis=0) for a in arrays]
    arrays[3] = rng.randn(B, T, C).astype(np.float32)  # a video's own emissions
    lengths = np.array([T, 13], np.int32)
    want = jh.hsmm_frame_marginals(jh.HsmmPotentials(*map(jnp.asarray, arrays)),
                                   jnp.asarray(lengths))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0] = ts[0][:1].expand(B, C, C)  # the model's expanded table
    pots = th.HsmmPotentials(*ts)
    assert hc._stack_fwd_rev(pots, torch.from_numpy(lengths).long())[0].dim() == 4
    got = hg.hsmm_frame_marginals_fast(pots, torch.from_numpy(lengths), hg.PLAIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("C", WIDE_CLASSES)
@pytest.mark.parametrize("Km", WIDE_KMS)
def test_wide_band_grad_and_traceback_tiles_fit_the_block(C, Km):
    """K4's tile and the traceback's at a wide DP: K4's wide kernel
    (``band_grad_wide_tile``) blocks of 8 warps over 32 classes, covering
    C, walking runs of whole rows, with its slab within a block's and an
    SM's shared memory and its lg partials within one plane (at 18
    videos of 1,024 frames and Km = 19 23 runs a video at C = 129, 10 at
    342, 7 at 1,024-1,577, 8 at 2,048); the narrow traceback's rule two
    buffers of rows * C codes in a block's; W2's ring 4 slots of 112 rows
    at C = 129, 42 at 342, 14 at 1,024, 9 at 1,577. The codes' radix
    holds C."""
    for B, T in ((18, 1024), (1, 1056), (4, 200)):
        tile = hc.band_grad_wide_tile(B, T, C, Km)
        assert tile.groups == -(-C // 32) and (tile.groups - 1) * 32 < C
        assert 1 <= tile.rows <= T and tile.tiles == -(-T // tile.rows)
        assert tile.threads == 32 * tile.warps <= hc.MAX_BLOCK_THREADS
        assert tile.smem_bytes == 4 * tile.slab * tile.threads <= hc.MAX_BLOCK_SMEM
        assert tile.blocks_per_sm * (tile.smem_bytes + hc.SM_SMEM_PER_BLOCK) <= hc.SM_SMEM
        assert tile.blocks_per_sm * tile.threads * hc.BAND_GRAD_WIDE_REGS <= hc.SM_REGS
        assert 1 <= tile.slab <= Km
        assert tile.scratch_bytes <= 4 * B * T * C
        tb = hc.traceback_tile(T, C)
        assert 1 <= tb.rows <= T
        assert tb.smem_bytes == hc.TRACEBACK_HEADER + 8 * hc._tile_words(tb.rows, C)
        assert tb.smem_bytes <= hc.MAX_BLOCK_SMEM
    assert hc.traceback_tile(1024, C).rows == {129: 225, 342: 84, 1024: 28, 1025: 28,
                                               1577: 18, 2048: 14}[C]
    assert hc.wide_traceback_tile(1024, C)[:2] == {129: (112, 4), 342: (42, 4), 1024: (14, 4),
                                                   1025: (14, 4), 1577: (9, 4), 2048: (7, 4)}[C]
    assert hc.band_grad_wide_tile(18, 1024, C, 19).tiles == {
        129: 23, 342: 10, 1024: 7, 1025: 7, 1577: 7, 2048: 8}[C]
    radix = hc.code_radix(C)
    assert radix >= C and (Km * radix) < 2 ** 31
    # a row of codes fits a slot of 4 up to 14,521 classes (past it the launch raises)
    assert hc.wide_traceback_tile(8, 14521).smem_bytes <= hc.MAX_BLOCK_SMEM
    assert hc.wide_traceback_tile(8, 14522).smem_bytes > hc.MAX_BLOCK_SMEM


def wide_traceback_copies(T, C, length, tile, off):
    """W2's tiles as the kernel cuts them (csrc/hsmm_viterbi.cu
    `traceback_wide_kernel`) for a video of `length` frames whose plane
    starts `off` words into a 16-byte line: (first, end) words of each
    tile's bulk copy, counted from that line, and its rows."""
    top = length - 1
    tiles = -(-top // tile.rows) if top > 0 else 0
    out = []
    for k in range(tiles):
        lo, hi = max(0, top - (k + 1) * tile.rows), top - k * tile.rows
        first, end = (lo * C + off) // 4 * 4, (hi * C + off + 3) // 4 * 4
        out.append((first, end, lo, hi))
    return out


@pytest.mark.parametrize("C", (129, 342, 664, 665, 1024, 1025, 1577, 2048))
@pytest.mark.parametrize("T", (1, 3, 84, 1024, 12000))
@pytest.mark.parametrize("Km", (1, 19, 25, 64))
def test_wide_traceback_ring_fits_the_block(C, T, Km):
    """W2's ring (``wide_traceback_tile``): at least one row a slot and no
    more than T; 4 slots, or as many as the plane's T - 1 shared rows make
    tiles of; each slot whole 16-byte lines after a header of whole lines
    (so every tile's body lands aligned); the ring within an H100 block's
    shared memory, and one more row a slot would not fit. Each tile's copy,
    widened to whole lines, fits its slot, stays within the plane, and the
    tiles cover the rows the walk reads; so do tiles cut shorter than a
    jump of Km + 1 rows (the wrapper's ring, then slots of Km // 2 rows)."""
    for max_rows in (None, max(1, Km // 2)):
        tile = hc.wide_traceback_tile(T, C, max_rows)
        assert 1 <= tile.rows <= min(T, max_rows or T)
        tiles = -(-(T - 1) // tile.rows)
        assert tile.stages == max(1, min(hc.WIDE_TRACEBACK_STAGES, tiles))
        header = hc._wide_traceback_header(tile.stages)
        slot = 4 * hc._wide_slot_words(tile.rows, C)
        assert header == 16 * tile.stages and slot % 16 == 0  # two mbarriers a slot
        assert tile.smem_bytes == header + tile.stages * slot <= hc.MAX_BLOCK_SMEM
        if max_rows is None and tile.rows < T:
            full = hc._wide_traceback_header(hc.WIDE_TRACEBACK_STAGES)
            assert full + hc.WIDE_TRACEBACK_STAGES * 4 * hc._wide_slot_words(
                tile.rows + 1, C) > hc.MAX_BLOCK_SMEM
        for length in sorted({1, min(2, T), T // 2 + 1, T}):
            for off in range(4):
                copies = wide_traceback_copies(T, C, length, tile, off)
                rows = set()
                for first, end, lo, hi in copies:
                    assert first % 4 == 0 and end % 4 == 0 and 16 <= 4 * (end - first) <= slot
                    assert 0 <= first and end <= off + T * C
                    rows |= set(range(lo, hi))
                assert rows == set(range(length - 1))
