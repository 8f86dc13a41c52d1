"""The wide scans' routes (ops/hsmm_cuda.py ``wide_scan_instance``) on
the CPU: which of csrc/hsmm_scan_wide.cu's two kernels a (C, Km) launches,
with how many blocks, and what the launch hands the kernel.

The cluster route holds a chain's transposed transition table in the
shared memory of a cluster of 1 to 8 blocks, each block the table's
columns of its slab of classes beside its ring and the two alpha rows;
it takes the smallest cluster that fits, the slab in whole warps where
that fits. Past it (a table that 8 blocks do not hold, or a ring too
deep) the grid route: one cooperative grid of at most one block an SM,
each block the (chain, class) pairs of a group of chains and a slab of
classes, its slab's table rows in shared memory where the block's chains
share one table and it fits. The kernels run only on the card
(tests/test_torch_gpu.py holds them against their plain versions); here
the rules and the wrapper's arguments are checked against a reckoning of
the kernels' layouts written out anew.
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm_cuda as hc

WIDEST = hc.WIDE_CLUSTER_MAX_CLASSES
SMS = hc.H100_SMS


def block_bytes(C, Km, slab):
    """A cluster-route block's shared memory: two mbarriers, two alpha rows
    of C floats rounded up to 4, a row of the table for each of the slab's
    classes (at most C) at a stride of 4 words past a multiple of 32, and
    the ring's Km rows of `slab` columns."""
    alpha = -(-C // 4) * 4
    row = alpha + (36 - alpha % 32) % 32
    assert row % 32 == 4 and row >= C
    return 4 * (4 + 2 * alpha + min(slab, C) * row + Km * slab)


def grid_bytes(C, Km, slab, chains, table, ring):
    """A grid-route block's shared memory: the table's rows of its slab
    (where they are shared) and its chains' alpha rows, each at a stride
    of 4 words past a multiple of 32, then a prefix sum and a duration
    argmax a pair, then the pairs' Km ring rows (where they are shared)."""
    alpha = -(-C // 4) * 4
    row = alpha + (36 - alpha % 32) % 32
    pairs = chains * slab
    return 4 * (slab * row * (table == "shared") + chains * row + 2 * pairs
                + Km * pairs * (ring == "shared"))


def reckoned(C, Km):
    """(route, blocks a chain, slab) by the rule, written out: for 1 to 8
    blocks, a slab in whole warps, else C split evenly, whichever first
    fits a block's 232,448 bytes within 256 threads; past that the grid
    route (no blocks a chain)."""
    for cluster in range(1, 9):
        even = -(-C // cluster)
        for slab in (32 * -(-even // 32), even):
            if block_bytes(C, Km, slab) <= 232448 and slab <= 256:
                return "cluster", -(-C // slab), slab
    return "grid", 0, None


# (C, Km) -> (route, blocks a chain): one block to C = 228 (the table's
# padded rows beside the alpha rows), two past it; the S6 shape's three;
# the widest cluster C takes 8 at Km = 1 only; the next C, 1,024 classes
# and the widths past them (1,577: all 83 CrossTask tasks) the grid route
EXPECTED = {
    (129, 1): ("cluster", 1), (129, 19): ("cluster", 1), (129, 64): ("cluster", 1),
    (228, 1): ("cluster", 1), (228, 19): ("cluster", 1), (229, 1): ("cluster", 2),
    (235, 1): ("cluster", 2), (235, 19): ("cluster", 2), (235, 64): ("cluster", 2),
    (236, 1): ("cluster", 2), (236, 19): ("cluster", 2), (236, 64): ("cluster", 2),
    (342, 1): ("cluster", 3), (342, 19): ("cluster", 3), (342, 64): ("cluster", 3),
    (WIDEST, 1): ("cluster", 8), (WIDEST, 19): ("grid", 0), (WIDEST, 64): ("grid", 0),
    (WIDEST + 1, 1): ("grid", 0), (WIDEST + 1, 19): ("grid", 0), (WIDEST + 1, 64): ("grid", 0),
    (1024, 1): ("grid", 0), (1024, 19): ("grid", 0), (1024, 64): ("grid", 0),
    (1025, 1): ("grid", 0), (1025, 19): ("grid", 0), (1025, 64): ("grid", 0),
    (1577, 1): ("grid", 0), (1577, 19): ("grid", 0), (1577, 64): ("grid", 0),
    (2048, 1): ("grid", 0), (2048, 19): ("grid", 0), (2048, 64): ("grid", 0),
}


@pytest.mark.parametrize("C,Km", sorted(EXPECTED))
def test_wide_route_and_cluster_size(C, Km):
    """The route and blocks a chain at the boundary widths, each as the
    rule written out reckons it, and each block within its limits."""
    inst = hc.wide_scan_instance(C, Km, 18, 18)
    assert (inst.route, inst.cluster) == EXPECTED[(C, Km)]
    route, cluster, slab = reckoned(C, Km)
    assert (inst.route, inst.cluster) == (route, cluster)
    assert inst.smem_bytes <= hc.MAX_BLOCK_SMEM
    if inst.route == "cluster":
        assert inst.slab == slab and inst.blocks == 18 * cluster
        assert inst.smem_bytes == block_bytes(C, Km, inst.slab)
        assert inst.threads == 32 * -(-inst.slab // 32) <= hc.WIDE_SLAB_THREADS
        # the smallest cluster: one block fewer does not fit
        if inst.cluster > 1:
            fewer = -(-C // (inst.cluster - 1))
            assert block_bytes(C, Km, fewer) > hc.MAX_BLOCK_SMEM or fewer > 256
    else:
        assert inst == hc.wide_grid_instance(C, Km, 18, 18)
        assert inst.blocks <= SMS
        assert inst.smem_bytes == grid_bytes(C, Km, inst.slab, inst.chains, inst.table,
                                             inst.ring)


def test_widest_cluster_c_is_the_constant():
    """WIDE_CLUSTER_MAX_CLASSES is the widest C the cluster route takes at
    any Km: 8 blocks of 83 classes at Km = 1 (230,092 bytes a block); at
    one class more a slab of 84 takes 232,832."""
    assert hc.wide_scan_instance(WIDEST, 1)[:3] == ("cluster", 8, 83)
    assert block_bytes(WIDEST, 1, 83) == hc.wide_cluster_smem(WIDEST, 1, 83) == 230092
    assert block_bytes(WIDEST + 1, 1, 84) == 232832 > hc.MAX_BLOCK_SMEM
    assert all(hc.wide_scan_instance(C, 1).route == "cluster" for C in range(129, WIDEST + 1))


@pytest.mark.parametrize("Km", (1, 2, 19, 64, 200))
def test_never_cluster_above_the_constant(Km):
    """Above WIDE_CLUSTER_MAX_CLASSES every C takes the grid route, in one
    launch of at most one block an SM (1, 18 and 36 chains to 14,528
    classes, the widest that one block a chain once took), each within a
    block's shared memory and GRID_THREADS; to WIDE_GRID_MAX_CLASSES
    (57,220 on 132 SMs), where one chain's alpha row and its slab's state
    alone fill a block."""
    for C in [*range(WIDEST + 1, 4097, 7), 4096, 14528, hc.WIDE_GRID_MAX_CLASSES]:
        chains = ((1, 1), (18, 18), (36, 18)) if C <= 14528 else ((1, 1),)
        for N, group in chains:
            inst = hc.wide_scan_instance(C, Km, N, group)
            assert inst == hc.wide_grid_instance(C, Km, N, group)
            assert inst.route == "grid" and inst.launch_chains == N
            assert inst.smem_bytes <= hc.MAX_BLOCK_SMEM and inst.blocks <= SMS
            assert inst.threads == min(hc.GRID_THREADS, 32 * -(-inst.chains * inst.slab // 32))
    with pytest.raises(ValueError, match=str(hc.WIDE_GRID_MAX_CLASSES + 1)):
        hc.wide_grid_instance(hc.WIDE_GRID_MAX_CLASSES + 1, Km)


@pytest.mark.parametrize("C", (129, 200, 342, 500, WIDEST))
@pytest.mark.parametrize("Km", (1, 19, 64))
def test_a_deeper_ring_never_takes_fewer_blocks(C, Km):
    """At one C, more duration rows (a deeper ring a block) take as many
    blocks a chain or more, and the grid route once 8 do not hold it."""
    a, b = hc.wide_scan_instance(C, Km), hc.wide_scan_instance(C, 2 * Km + 10)
    assert a.route == "cluster" or b.route == "grid"
    if b.route == "cluster":
        assert b.cluster >= a.cluster


def owners(inst, N, C):
    """{(chain, class): [block]} of a grid launch as the kernel reckons its
    blocks: block b the chains (b // slabs) * chains + i and the classes
    (b % slabs) * slab + j, within N and C."""
    slabs = -(-C // inst.slab)
    out = {}
    blocks = -(-N // inst.chains) * slabs
    for b in range(blocks):
        n0, c0 = b // slabs * inst.chains, b % slabs * inst.slab
        for p in range(inst.chains * inst.slab):
            n, c = n0 + p // inst.slab, c0 + p % inst.slab
            if n < N and c < C:
                out.setdefault((n, c), []).append(b)
    return out, blocks


GRID_CLASSES = (665, 1024, 1025, 1577, 2048, 3000, 14528)
GRID_KMS = (1, 19, 64)


@pytest.mark.parametrize("C", GRID_CLASSES)
@pytest.mark.parametrize("Km", GRID_KMS)
@pytest.mark.parametrize("N,group", [(1, 1), (2, 1), (18, 18), (36, 18), (36, 1)])
def test_grid_launch_fits_the_card(C, Km, N, group):
    """The grid route's launch (``wide_grid_instance``): every (chain,
    class) pair owned by exactly one block, no block empty; the blocks
    within the card's 132 SMs at one a block (a block of at most
    GRID_THREADS within one SM's shared memory stays resident), each
    block's shared memory within a block's; the table slab in shared
    memory only where the block's chains read one table."""
    inst = hc.wide_grid_instance(C, Km, N, group, SMS)
    assert inst.route == "grid" and inst.launch_chains == N
    if C * N <= 40000:  # the pairs written out
        own, blocks = owners(inst, N, C)
        assert len(own) == N * C and all(len(v) == 1 for v in own.values())
        assert {b for v in own.values() for b in v} == set(range(blocks))
    blocks = -(-N // inst.chains) * -(-C // inst.slab)
    assert inst.blocks == blocks <= SMS
    assert 32 <= inst.threads <= hc.GRID_THREADS and inst.threads % 32 == 0
    assert inst.smem_bytes == grid_bytes(C, Km, inst.slab, inst.chains, inst.table, inst.ring)
    assert inst.smem_bytes + hc.SM_SMEM_PER_BLOCK <= hc.SM_SMEM
    if inst.table == "shared":
        assert group >= N or group % inst.chains == 0
    # the ring leaves shared memory only where it does not fit there
    if inst.ring == "global":
        assert grid_bytes(C, Km, inst.slab, inst.chains, inst.table, "shared") > \
            hc.MAX_BLOCK_SMEM


@pytest.mark.parametrize("C,Km,N,group,table", [
    (1577, 19, 18, 18, "shared"),  # the timed max scan: one expanded table, 9 chains a block
    (1577, 19, 2, 1, "shared"),  # segment_with_marginals on one video: two tables, two chains
    (1577, 19, 36, 18, "global"),  # the stacked 36: two tables beside 18 alpha rows do not fit
    (1577, 19, 18, 1, "global"),  # a table a chain: 179 MB, past the card's shared memory
    (1024, 19, 18, 18, "shared"),
    (2048, 19, 18, 18, "global"),  # 16.8 MB of table beside the alpha rows
    (665, 64, 18, 18, "shared"),
    (14528, 19, 1, 1, "global"),
])
def test_grid_table_falls_back_to_global_memory(C, Km, N, group, table):
    """Where the table slab lives: in shared memory where the batch's
    tables fit beside the alpha rows, else read from global memory."""
    inst = hc.wide_grid_instance(C, Km, N, group)
    assert inst.table == table
    if table == "global":  # the tiling's slab would not fit beside its chains' alpha rows
        assert grid_bytes(C, Km, inst.slab, inst.chains, "shared", "global") > hc.MAX_BLOCK_SMEM \
            or (group < N and group % inst.chains)


def test_grid_timed_shape_tilings():
    """At B=18, T=1024, C=1,577, K=20 (the timed shape): the max and
    forward scans 132 blocks of 9 chains x 24 classes with the table slab
    and the ring in shared memory; the log scan's 36 stacked chains (two
    tables) 132 blocks of 18 chains x 24 classes reading the slab from
    global memory; one chain at a time (segment_with_marginals on a video)
    132 blocks of 12 classes."""
    assert hc.wide_grid_instance(1577, 19, 18, 18)[2:9] == (
        24, 9, 132, 224, "shared", "shared", 229872)
    assert hc.wide_grid_instance(1577, 19, 36, 18)[2:8] == (24, 18, 132, 448, "global", "shared")
    assert hc.wide_grid_instance(1577, 19, 1, 1)[2:6] == (12, 1, 132, 32)


@pytest.mark.parametrize("N,group", [(400, 1), (400, 400), (300, 150)])
def test_grid_splits_a_batch_no_grid_holds(N, group):
    """At 14,528 classes one block holds at most 100 chains of the whole
    C (their alpha rows and state), so 400 chains take launches of at
    most ``launch_chains``, none across a shared table, the table read
    from global memory; every chain in exactly one launch."""
    inst = hc.wide_grid_instance(14528, 19, N, group)
    assert inst.launch_chains < N and inst.table == "global"
    G = -(-N // group)
    chunks = hc._grid_chunks(N, G, group, inst.launch_chains)
    covered = []
    for a, b, ta, tb, grp in chunks:
        assert 0 < b - a <= inst.launch_chains
        covered += list(range(a, b))
        if group == 1:
            assert (ta, tb, grp) == (a, b, 1)
        else:  # one table, every chain of the launch reading it
            assert tb - ta == 1 and ta == a // group == (b - 1) // group and grp == b - a
    assert covered == list(range(N))
    assert hc._grid_chunks(36, 2, 18, 36) == [(0, 36, 0, 2, 18)]


@pytest.mark.parametrize("C,Km", [(200, 19), (342, 19), (1024, 19), (1024, 64), (1025, 19),
                                  (1577, 19), (1577, 64), (2048, 19)])
@pytest.mark.parametrize("symbol,kind", [("hsmm_wide_viterbi_scan", "ab"),
                                         ("hsmm_wide_log_scan", "ga"),
                                         ("hsmm_wide_forward_scan", "a")])
@pytest.mark.parametrize("shared", (False, True))
def test_wide_launch_passes_the_route(monkeypatch, C, Km, symbol, kind, shared):
    """``_launch_wide_scan`` hands the cluster route trans transposed
    ([from][to]) and null scratch (after the outputs: the log scans' planes
    and then their offsets, as their wrappers pass them), the grid route the tables' rows padded
    to the table stride ([to][from]), the exchange rows (N, 2, stride), a
    ring scratch only where the ring is in global memory, and a counter;
    then N, T, C, Km, [radix,] the blocks a chain (0 for the grid route
    with its table slab in shared memory, -1 in global memory), the slab,
    the chains a block, the shared memory and the chains a table: 1 for a
    table a chain, N for an expanded table (batch stride 0), which goes to
    the kernel once."""
    calls = []
    monkeypatch.setattr(hc, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(hc, "_call", lambda lib, sym, ptrs, ints, of: calls.append(
        (lib, sym, ptrs, ints)) or 0)
    rng = np.random.RandomState(C + Km)
    N, T = 2, 5
    if shared:
        trans = torch.from_numpy(rng.randn(C, C).astype(np.float32)).expand(N, C, C)
    else:
        trans = torch.from_numpy(rng.randn(N, C, C).astype(np.float32))
    init = torch.zeros((N, C))
    dur = torch.zeros((N, Km, C))
    emit = torch.zeros((N, T, C))
    outs = [torch.empty((N, T, C)) for _ in kind]
    if "b" not in kind:  # the log scans' offsets
        outs.append(torch.empty((N, hc.fold_blocks(T))))
    radix = [hc.code_radix(C)] if "b" in kind else []
    assert hc._launch_wide_scan(symbol, symbol, trans, init, dur, emit, outs, radix) == 1
    (lib, sym, ptrs, ints), = calls
    group = N if shared else 1
    inst = hc.wide_scan_instance(C, Km, N, group)
    assert (lib, sym) == ("hsmm_scan_wide", symbol)
    tables = trans[:1] if shared else trans
    assert [p.data_ptr() for p in ptrs[1:4]] == [x.data_ptr() for x in (init, dur, emit)]
    assert [p.data_ptr() for p in ptrs[4:4 + len(outs)]] == [o.data_ptr() for o in outs]
    assert len(ptrs) == 4 + len(outs) + 3
    xchg, ring, counter = ptrs[-3:]
    if inst.route == "cluster":
        assert torch.equal(ptrs[0], tables.transpose(1, 2)) and ptrs[0].is_contiguous()
        assert xchg is ring is counter is None
        code = inst.cluster
    else:
        stride = hc._table_stride(C)
        assert tuple(ptrs[0].shape) == (tables.shape[0], C, stride)
        assert torch.equal(ptrs[0][..., :C], tables)
        assert tuple(xchg.shape) == (N, 2, stride) and counter.dtype == torch.int32
        if inst.ring == "global":
            assert tuple(ring.shape) == (inst.blocks, Km, inst.chains * inst.slab)
        else:
            assert ring is None
        code = 0 if inst.table == "shared" else -1
    assert ints == [N, T, C, Km, *radix, code, inst.slab, inst.chains, inst.smem_bytes, group]
