"""The wide scans' routes (ops/hsmm_cuda.py ``wide_scan_instance``) on
the CPU: which of csrc/hsmm_scan_wide.cu's two kernels a (C, Km) launches,
with how many blocks a chain, and what the launch hands the kernel.

The cluster route holds a chain's transposed transition table in the
shared memory of a cluster of 1 to 8 blocks, each block the table's
columns of its slab of classes beside its ring and the two alpha rows;
it takes the smallest cluster that fits, the slab in whole warps where
that fits. Past it (a table that 8 blocks do not hold, or a ring too
deep) the L2 route, one block a chain reading the table from L2. The
kernels run only on the card (tests/test_torch_gpu.py holds them against
their plain versions); here the rule and the wrapper's arguments are
checked against a reckoning of the kernel's layout written out anew.
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm_cuda as hc

WIDEST = hc.WIDE_CLUSTER_MAX_CLASSES


def block_bytes(C, Km, slab):
    """A cluster-route block's shared memory: two mbarriers, two alpha rows
    of C floats rounded up to 4, a row of the table for each of the slab's
    classes (at most C) at a stride of 4 words past a multiple of 32, and
    the ring's Km rows of `slab` columns."""
    alpha = -(-C // 4) * 4
    row = alpha + (36 - alpha % 32) % 32
    assert row % 32 == 4 and row >= C
    return 4 * (4 + 2 * alpha + min(slab, C) * row + Km * slab)


def reckoned(C, Km):
    """(route, blocks a chain, slab) by the rule, written out: for 1 to 8
    blocks, a slab in whole warps, else C split evenly, whichever first
    fits a block's 232,448 bytes within 256 threads."""
    for cluster in range(1, 9):
        even = -(-C // cluster)
        for slab in (32 * -(-even // 32), even):
            if block_bytes(C, Km, slab) <= 232448 and slab <= 256:
                return "cluster", -(-C // slab), slab
    return "l2", 1, C


# (C, Km) -> (route, blocks a chain): one block to C = 228 (the table's
# padded rows beside the alpha rows), two past it; the S6 shape's three;
# the widest cluster C takes 8 at Km = 1 only; the next C, 1,024 classes
# and the widths past them (1,577: all 83 CrossTask tasks) the L2 route
EXPECTED = {
    (129, 1): ("cluster", 1), (129, 19): ("cluster", 1), (129, 64): ("cluster", 1),
    (228, 1): ("cluster", 1), (228, 19): ("cluster", 1), (229, 1): ("cluster", 2),
    (235, 1): ("cluster", 2), (235, 19): ("cluster", 2), (235, 64): ("cluster", 2),
    (236, 1): ("cluster", 2), (236, 19): ("cluster", 2), (236, 64): ("cluster", 2),
    (342, 1): ("cluster", 3), (342, 19): ("cluster", 3), (342, 64): ("cluster", 3),
    (WIDEST, 1): ("cluster", 8), (WIDEST, 19): ("l2", 1), (WIDEST, 64): ("l2", 1),
    (WIDEST + 1, 1): ("l2", 1), (WIDEST + 1, 19): ("l2", 1), (WIDEST + 1, 64): ("l2", 1),
    (1024, 1): ("l2", 1), (1024, 19): ("l2", 1), (1024, 64): ("l2", 1),
    (1025, 1): ("l2", 1), (1025, 19): ("l2", 1), (1025, 64): ("l2", 1),
    (1577, 1): ("l2", 1), (1577, 19): ("l2", 1), (1577, 64): ("l2", 1),
    (2048, 1): ("l2", 1), (2048, 19): ("l2", 1), (2048, 64): ("l2", 1),
}


@pytest.mark.parametrize("C,Km", sorted(EXPECTED))
def test_wide_route_and_cluster_size(C, Km):
    """The route and blocks a chain at the boundary widths, each as the
    rule written out reckons it, and each block within its limits."""
    inst = hc.wide_scan_instance(C, Km)
    assert (inst.route, inst.cluster) == EXPECTED[(C, Km)]
    assert (inst.route, inst.cluster, inst.slab) == reckoned(C, Km)
    assert inst.smem_bytes <= hc.MAX_BLOCK_SMEM
    if inst.route == "cluster":
        assert inst.smem_bytes == block_bytes(C, Km, inst.slab)
        assert inst.threads == 32 * -(-inst.slab // 32) <= hc.WIDE_SLAB_THREADS
        # the smallest cluster: one block fewer does not fit
        if inst.cluster > 1:
            fewer = -(-C // (inst.cluster - 1))
            assert block_bytes(C, Km, fewer) > hc.MAX_BLOCK_SMEM or fewer > 256


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
    """Above WIDE_CLUSTER_MAX_CLASSES every C takes the L2 route, its ring
    in shared memory where it fits beside the alpha rows and the per-class
    state (4 C words), in a block of at most 1,024 threads; to 14,528
    classes, where the state alone fills a block's shared memory."""
    for C in [*range(WIDEST + 1, 4097), 14528]:
        inst = hc.wide_scan_instance(C, Km)
        assert inst == hc.wide_l2_instance(C, Km)
        assert inst.route == "l2" and inst.smem_bytes <= hc.MAX_BLOCK_SMEM
        assert inst.threads == min(1024, 32 * -(-C // 32))
    assert hc.wide_l2_instance(14529, Km).smem_bytes > hc.MAX_BLOCK_SMEM


@pytest.mark.parametrize("C", (129, 200, 342, 500, WIDEST))
@pytest.mark.parametrize("Km", (1, 19, 64))
def test_a_deeper_ring_never_takes_fewer_blocks(C, Km):
    """At one C, more duration rows (a deeper ring a block) take as many
    blocks a chain or more, and the L2 route once 8 do not hold it."""
    a, b = hc.wide_scan_instance(C, Km), hc.wide_scan_instance(C, 2 * Km + 10)
    assert a.route == "cluster" or b.route == "l2"
    if b.route == "cluster":
        assert b.cluster >= a.cluster


@pytest.mark.parametrize("C,Km", [(200, 19), (342, 19), (1024, 19), (1024, 64), (1025, 19),
                                  (1577, 19), (1577, 64), (2048, 19)])
@pytest.mark.parametrize("symbol,kind", [("hsmm_wide_viterbi_scan", "ab"),
                                         ("hsmm_wide_log_scan", "ga"),
                                         ("hsmm_wide_forward_scan", "a")])
@pytest.mark.parametrize("shared", (False, True))
def test_wide_launch_passes_the_route(monkeypatch, C, Km, symbol, kind, shared):
    """``_launch_wide_scan`` hands the kernel trans transposed ([from][to]),
    the outputs, a (N, Km, C) ring scratch only on the L2 route with its
    ring in global memory, and N, T, C, Km, [radix,] the blocks a chain (0
    for the L2 route), the slab, the shared memory and the chains a table:
    1 for a table a chain, N for an expanded table (batch stride 0), which
    goes to the kernel once."""
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
    outs = [torch.empty(0) for _ in kind]
    radix = [hc.code_radix(C)] if "b" in kind else []
    hc._launch_wide_scan(symbol, symbol, trans, init, dur, emit, outs, radix)
    (lib, sym, ptrs, ints), = calls
    inst = hc.wide_scan_instance(C, Km)
    assert (lib, sym) == ("hsmm_scan_wide", symbol)
    tables = trans[:1] if shared else trans
    assert torch.equal(ptrs[0], tables.transpose(1, 2)) and ptrs[0].is_contiguous()
    assert ptrs[1:4] == [init, dur, emit] and ptrs[4:-1] == outs
    ring = ptrs[-1]
    if inst.ring == "global":
        assert inst.route == "l2" and tuple(ring.shape) == (N, Km, C)
    else:
        assert ring is None
    cluster = inst.cluster if inst.route == "cluster" else 0
    assert ints == [N, T, C, Km, *radix, cluster, inst.slab, inst.smem_bytes, N if shared else 1]
