"""Rank bodies of the port's data-parallel tests.

``parallel.mesh.run_ranks`` spawns each rank and imports the function it
runs by name, so these live apart from the test files: this module
imports the port alone (no JAX), and a rank starts in seconds. The test
files build the arguments (with the JAX package's parser, as every port
test does) and hold the ranks' results against the single path and the
JAX package. Every function here returns CPU tensors and plain values.
"""

import contextlib
import logging
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from action_segmentation_torch import checkpoint
from action_segmentation_torch import main as tmain
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.graft_entry import _Batch, _grads
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.parallel.mesh import (
    COLLECTIVE_TIMEOUT,
    make_mesh,
    replicas_differ,
)
from action_segmentation_torch.utils import logger

STAT_KEYS = ("train_loss", "train_nll_frame_avg", "train_kl_vid_avg", "train_recon_bound")


@contextlib.contextmanager
def process_group(backend, device=None):
    """A process group of one rank in this process (`backend` over a
    ``file://`` store in a temporary directory), destroyed on exit;
    yields its Mesh."""
    with tempfile.TemporaryDirectory(prefix="aseg_group_") as tmp:
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
        try:
            yield make_mesh(1, device=device)
        finally:
            dist.destroy_process_group()


def cpu_state(module):
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def fit(args, split, use_labels, state=None, predict=False, device="cpu", mesh=None,
        predict_args=None):
    """Fit a port model on SyntheticDatasplit(**split), from the state dict
    `state` where given: {"stats": [(epoch, [STAT_KEYS values])],
    "params", "resident": the fit's split had a resident corpus,
    "predictions" (with `predict`; under `predict_args` where given),
    "differ": state tensors unequal to rank 0's (under a `mesh`)}."""
    train = TSplit(**split)
    model = TModel.from_args(args, train, device=device)
    if state is not None:
        model.module.load_state_dict(state)
    stats = []
    model.fit(train, use_labels=use_labels, callback_fn=lambda e, s: stats.append(
        (e, [s[k] for k in STAT_KEYS] if s else [])))
    out = {"stats": stats, "params": cpu_state(model.module),
           "resident": model._get_resident(train, False) is not None}
    if predict:
        if predict_args is not None:
            model.args = predict_args
        out["predictions"] = model.predict(train)
    if mesh is not None:
        out["differ"] = replicas_differ(mesh, model.module)
    return out


def predict(args, split, state, device="cpu"):
    """The predictions of a port model holding `state` on its split."""
    train = TSplit(**split)
    model = TModel.from_args(args, train, device=device)
    model.module.load_state_dict(state)
    return model.predict(train)


def run(mesh, jobs):
    """{name: result} on this rank for jobs {name: (kind, keyword
    arguments)}: a ``fit`` or a ``predict`` on this rank's device, or one
    of this module's rank bodies (``grad_step``, ``decode_step``,
    ``logged_fit``, ``resume``, ``cli``) called with the mesh."""
    out = {}
    for name, (kind, kwargs) in jobs.items():
        if kind == "fit":
            out[name] = fit(device=mesh.device, mesh=mesh, **kwargs)
        elif kind == "predict":
            out[name] = predict(device=mesh.device, **kwargs)
        else:
            out[name] = globals()[kind](mesh, **kwargs)
    return out


def _model(mesh, args, state, C, D):
    from action_segmentation_torch.models.semimarkov import GaussianHsmm

    module = GaussianHsmm(args, C, D, allow_self_transitions=True, device=mesh.device)
    module.load_state_dict(state)
    return TModel(args, C, D, module, mesh.device)


def decode_step(mesh, args, state, arrays, C):
    """The batch's labels and scores (every row) on this rank, each rank
    decoding its rows of `arrays` (features, lengths, gt, cons,
    end_allowed; numpy)."""
    from action_segmentation_torch.parallel.mesh import combine_rows

    model = _model(mesh, args, state, C, arrays[0].shape[2])
    (f, le, vc, _, _, cons, end, _), shard, B = _Batch(*arrays, C).local(mesh)
    labels, scores = model._decode(f, le, vc, cons, end, shard)
    return (combine_rows(mesh, labels, shard.padded)[:B].cpu(),
            combine_rows(mesh, scores, shard.padded)[:B].cpu())


def grad_step(mesh, args, state, arrays, C, use_labels):
    """One step's global loss and gradients (by parameter name) over the
    batch `arrays` (features, lengths, gt, cons, end_allowed; numpy),
    this rank differentiating its rows of it."""
    model = _model(mesh, args, state, C, arrays[0].shape[2])
    loss = _grads(model, _Batch(*arrays, C), mesh, use_labels)
    return loss, {n: p.grad.detach().cpu().clone() for n, p in model.module.named_parameters()}


def logged_fit(mesh, args, split):
    """The |GParam| training lines a fit logs on this rank."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(logging.DEBUG)
    logger.addHandler(handler)
    try:
        fit(args, split, True, device=mesh.device)
    finally:
        logger.removeHandler(handler)
    return [line for line in lines if "|GParam|" in line]


def resume(mesh, full, part, resumed, split):
    """An uninterrupted fit (args `full`), a fit that stops early (`part`)
    and its --resume (`resumed`), each checkpointing every epoch."""
    return [fit(args, split, True, device=mesh.device, mesh=mesh)
            for args in (full, part, resumed)]


def cli(mesh, argv):
    """main.main(argv) on this rank with numpy's global stream seeded at
    every test() (F1 samples frames from it): (stats, the pickles and
    prediction sets this rank wrote)."""
    writes = {"pickles": 0, "predictions": 0}
    save_pickle, write_predictions, test = (checkpoint.save_pickle,
                                            tmain.write_predictions, tmain.test)

    def counted_pickle(*args, **kwargs):
        writes["pickles"] += 1
        return save_pickle(*args, **kwargs)

    def counted_predictions(*args, **kwargs):
        writes["predictions"] += 1
        return write_predictions(*args, **kwargs)

    def seeded_test(*args, **kwargs):
        np.random.seed(0)
        return test(*args, **kwargs)

    checkpoint.save_pickle, tmain.write_predictions, tmain.test = (
        counted_pickle, counted_predictions, seeded_test)
    try:
        stats = tmain.main(argv, device=mesh.device)
    finally:
        checkpoint.save_pickle, tmain.write_predictions, tmain.test = (
            save_pickle, write_predictions, test)
    return stats, writes


def seeded_main(argv, device="cpu"):
    """main.main(argv) with numpy's global stream seeded at every test()."""
    test = tmain.test

    def seeded_test(*args, **kwargs):
        np.random.seed(0)
        return test(*args, **kwargs)

    tmain.test = seeded_test
    try:
        return tmain.main(argv, device=device)
    finally:
        tmain.test = test


def tensors_equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
