"""The port's resident corpus under data parallelism, on the CPU, under gloo.

Twins of tests/test_resident_scan.py's four --data_parallel tests at
their tolerances, at world 2 and at an uneven world 3: the DP resident
fit and predict against the single resident path; DP resident against DP
streaming (--sm_device_resident_mb 0), bit for bit here, since a gathered
rank slice equals the streamed one; the compound model's latent noise,
which each rank takes from the single path's draw; and
--sm_reference_pooling, whose window is the whole batch's longest video
across the ranks. Beyond them, in this process: each rank's gathered rows
equal its streamed rows tensor for tensor, and the ranks' rows tile the
batch.
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.parallel import mesh as tmesh
from tests import torch_parallel_cases as cases
from tests.conftest import make_sm_args

WORLDS = (2, 3)
UNIFORM = dict(num_videos=24, n_classes=3, max_len=20, min_len=20, span_k=4, seed=7)
PARTIAL = dict(num_videos=20, n_classes=3, max_len=20, min_len=20, span_k=4, seed=8)
LATENT = dict(num_videos=16, n_classes=3, max_len=20, min_len=20, span_k=4, feature_dim=8,
              seed=9)
RAGGED = dict(num_videos=16, n_classes=3, max_len=40, min_len=8, span_k=4, feature_dim=8,
              seed=12)
COMPOUND = dict(sm_component_model=True, sm_component_embedding_dim=12, sm_component_z_dim=4,
                sm_component_z_hidden_dim=12)


def cfg(dp, **over):
    base = dict(sm_max_span_length=8, epochs=3, lr=1e-2, batch_size=10, seed=3)
    base.update(over)
    return make_sm_args(data_parallel=dp, **base)


FITS = {
    "single_scan": (UNIFORM, True, dict(sm_supervised_method="closed-then-gradient",
                                        epochs=2, batch_size=8)),
    "streaming": (PARTIAL, True, dict(sm_supervised_method="closed-then-gradient", epochs=2,
                                      batch_size=8, sm_device_resident_mb=0)),
    "resident": (PARTIAL, True, dict(sm_supervised_method="closed-then-gradient", epochs=2,
                                     batch_size=8)),
    "compound_z": (LATENT, False, dict(epochs=2, batch_size=8, **COMPOUND)),
}
POOLING = dict(epochs=1, batch_size=8, sm_reference_pooling=True, **COMPOUND)


def fit_job(name, dp):
    split, use_labels, over = FITS[name]
    return dict(args=cfg(dp, **over), split=split, use_labels=use_labels, predict=True)


@pytest.fixture(scope="module")
def singles():
    out = {name: cases.fit(**fit_job(name, False)) for name in ("single_scan", "compound_z")}
    out["pooling"] = cases.fit(cfg(False, **POOLING), RAGGED, False, predict=True)
    return out


@pytest.fixture(scope="module")
def ranks(singles):
    jobs = {name: ("fit", fit_job(name, True)) for name in FITS}
    jobs["pooling"] = ("predict", dict(args=cfg(True, **POOLING), split=RAGGED,
                                       state=singles["pooling"]["params"]))
    return {world: tmesh.run_ranks(cases.run, world, jobs) for world in WORLDS}


def assert_predictions_equal(got, want):
    assert sorted(got) == sorted(want)
    for video in want:
        np.testing.assert_array_equal(got[video], want[video], err_msg=video)


def stat_rows(result):
    return [stats for _, stats in result["stats"] if stats]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_resident_matches_single_resident(ranks, singles, world):
    """Closed form then gradient, resident at world `world` and in one
    process: epoch stats rtol 1e-5, parameters atol 5e-4, labels equal."""
    for got in ranks[world]:
        want = singles["single_scan"]
        got = got["single_scan"]
        assert got["resident"] and want["resident"]
        np.testing.assert_allclose(stat_rows(got), stat_rows(want), rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=5e-4, err_msg=k)
        assert_predictions_equal(got["predictions"], want["predictions"])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_resident_matches_dp_streaming(ranks, world):
    """20 videos at batch 8 (a partial last batch): the DP resident fit and
    the DP streaming fit, epoch stats, parameters and labels bit for bit;
    every rank's parameters rank 0's."""
    for rank in ranks[world]:
        res, streamed = rank["resident"], rank["streaming"]
        assert res["resident"] and not streamed["resident"]
        assert res["stats"] == streamed["stats"]
        assert cases.tensors_equal(res["params"], streamed["params"])
        assert_predictions_equal(res["predictions"], streamed["predictions"])
        assert res["differ"] == streamed["differ"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_dp_resident_compound_z_keys(ranks, singles, world):
    """The compound model with a latent, unsupervised: each rank's noise is
    its rows of the single path's draw, so the stats track the single
    resident fit at rtol 1e-4 / atol 1e-6, and z was drawn (kl > 0)."""
    want = stat_rows(singles["compound_z"])
    assert want[0][2] > 1e-4
    for rank in ranks[world]:
        np.testing.assert_allclose(stat_rows(rank["compound_z"]), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_reference_pooling_matches_single(ranks, singles, world):
    """--sm_reference_pooling pools to the batch's longest video: under DP
    the window is the longest over every rank's rows, so a ragged corpus
    decodes to the single path's labels exactly."""
    for rank in ranks[world]:
        assert_predictions_equal(rank["pooling"], singles["pooling"]["predictions"])


def _model_and_split(world_batch=8):
    train = TSplit(**{**RAGGED, "num_videos": 13})
    args = cfg(False, batch_size=world_batch, sm_max_span_length=8)
    return TModel.from_args(args, train, device="cpu"), train


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gathered_rank_rows_equal_streamed_rank_rows(world):
    """Each rank's rows of every batch of an epoch: gathered from the
    resident corpus (a plan padded to the world) and streamed (JAX's
    padding, this rank's rows copied) are equal tensor for tensor, with
    the same Shard."""
    model, train = _model_and_split()
    resident = model._get_resident(train, False)
    assert resident is not None
    for rank in range(world):
        mesh = tmesh.Mesh(None, rank, world, torch.device("cpu"))
        streamed = list(model._streamed_batches(train, 5, False, mesh))
        gathered = list(model._resident_batches(resident, 5, mesh))
        assert len(streamed) == len(gathered) == 2
        for s, g in zip(streamed, gathered):
            assert s[:3] == g[:3] and s[4] == g[4]
            assert s[4].padded == -(-8 // world) * world
            for a, b in zip(s[3], g[3]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 3])
def test_rank_rows_tile_the_batch(world):
    """The ranks' gathered rows, in rank order, are the whole padded batch."""
    from action_segmentation_torch.data.resident import gather_resident_rows

    model, train = _model_and_split()
    resident = model._get_resident(train, False)
    plan = resident.make_plan(8, shuffle=True, seed=5, global_order=True, pad_rows_to=world)
    table = resident.upload_plan(plan)
    for b in plan.batches():
        whole = gather_resident_rows(resident, table, b)
        per = whole[0].shape[0] // world
        parts = [gather_resident_rows(resident, table, b, rows=(r * per, (r + 1) * per))
                 for r in range(world)]
        for i in (0, 1, 4, 5, 6, 7):  # features, lengths, gt, cons, end, weights
            assert torch.equal(torch.cat([p[i] for p in parts]), whole[i]), i
        assert all(torch.equal(p[2], whole[2]) and torch.equal(p[3], whole[3]) for p in parts)
