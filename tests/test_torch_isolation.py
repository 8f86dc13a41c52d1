"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU.

The port must run on a CUDA machine that has no JAX, so no file of
``action_segmentation_torch/`` nor ``chip_smoke.py`` may import ``jax``
or anything of ``action_segmentation_tpu``; and an entry point asked to
run on a card that is absent raises instead of carrying on on the CPU.
"""

import ast
from pathlib import Path

import pytest
import torch

import action_segmentation_torch
from action_segmentation_torch import BIG_NEG, resolve_device
from action_segmentation_torch.data.synthetic import SyntheticDatasplit
from action_segmentation_torch.models.semimarkov import GaussianHsmm, SemiMarkovModel
from action_segmentation_torch.ops.hsmm_cuda import (
    MAX_CLASSES,
    hsmm_band_max,
    hsmm_gamma_scan,
    kernel_path,
    kernels_supported,
)
from tests.conftest import make_sm_args

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "action_segmentation_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "optax", "action_segmentation_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_no_jax(path):
    bad = [
        m for m in _imported_modules(path)
        if m and m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, (str(path), bad)


def test_port_has_files():
    # the scan above must see the whole package, not an empty glob
    names = {p.name for p in PORT_FILES}
    assert {"hsmm_cuda.py", "hsmm_grad.py", "semimarkov.py", "api.py", "chip_smoke.py",
            "corpus.py", "crosstask.py", "breakfast.py", "minigen.py", "features.py",
            "batching.py", "f1.py", "main.py", "framewise.py", "sequential.py",
            "editdistance.py", "stats.py", "distributions.py"} <= names
    sources = {p.name for p in (ROOT / "action_segmentation_torch" / "csrc").glob("*.c*")}
    assert {"hsmm_scan.cu", "band_max.cu", "band_grad.cu", "hsmm_viterbi.cu",
            "editdistance.cpp"} <= sources


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train = SyntheticDatasplit(num_videos=2, n_classes=3, max_len=10, span_k=3)
    args = make_sm_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemiMarkovModel.from_args(args, train)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianHsmm(args, 3, 3)
    assert resolve_device("cpu") == torch.device("cpu")
    model = SemiMarkovModel.from_args(args, train, device="cpu")
    assert model.device == torch.device("cpu")


@pytest.mark.parametrize("classifier", ["framewise_discriminative",
                                        "framewise_gaussian_mixture", "framewise_baseline",
                                        "sequential_discriminative", "sequential_ground_truth"])
def test_baselines_raise_without_cuda(monkeypatch, classifier):
    """The baselines' entry point is the card too; device='cpu' runs them
    on the CPU. (The canonical and constraint baselines need a CrossTask
    split; test_torch_baselines.py covers their pickles' loads.)"""
    from action_segmentation_torch import main as tmain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train = SyntheticDatasplit(num_videos=2, n_classes=3, max_len=10, span_k=3)
    args = tmain.build_parser().parse_args(["--classifier", classifier])
    cls = tmain.CLASSIFIERS[classifier]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls.from_args(args, train)
    assert cls.from_args(args, train, device="cpu").device == torch.device("cpu")


def test_precision_pins():
    assert BIG_NEG == -1e9
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert action_segmentation_torch.__version__


def test_kernel_gate_and_other_devices():
    """The C <= 128 gate is by shape only; wrappers take CPU tensors (the
    plain versions, no launch counted) or CUDA tensors, nothing else."""
    assert kernels_supported(MAX_CLASSES) and not kernels_supported(MAX_CLASSES + 1)
    meta = torch.empty((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        hsmm_gamma_scan(torch.empty((2, 3, 3), device="meta"),
                        torch.empty((2, 3), device="meta"),
                        torch.empty((2, 1, 3), device="meta"), meta)
    with pytest.raises(ValueError, match="meta"):
        hsmm_band_max(meta, torch.empty((2, 6, 3), device="meta"),
                      torch.empty((2, 1, 3), device="meta"))
    before = (hsmm_gamma_scan.launches, hsmm_band_max.launches)
    g, _ = hsmm_gamma_scan(torch.zeros(2, 3, 3), torch.zeros(2, 3),
                           torch.zeros(2, 1, 3), torch.zeros(2, 4, 3))
    hsmm_band_max(torch.zeros(2, 4, 3), torch.zeros(2, 6, 3), torch.zeros(2, 1, 3))
    assert g.shape == (2, 4, 3)
    assert (hsmm_gamma_scan.launches, hsmm_band_max.launches) == before


def test_kernel_path_chooses_by_device():
    """Decode chooses its chain by the model's class count on both devices
    (the labels kernels at <= 128 classes, the exact-spans kernels above);
    on the card every call runs kernels, at any width. The 342-class
    CrossTask model takes the spans chain and the partition's kernels on
    the card, whether its DP is a task's 20 classes or all 342, and so
    does the 1,577-class model of all 83 tasks."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert kernel_path(MAX_CLASSES, MAX_CLASSES, cpu) == ("labels", "kernels")
    assert kernel_path(MAX_CLASSES + 1, MAX_CLASSES + 1, cpu) == ("spans", "autograd")
    assert kernel_path(342, 20, cpu) == ("spans", "autograd")
    assert kernel_path(MAX_CLASSES, MAX_CLASSES, cuda) == ("labels", "kernels")
    assert kernel_path(342, 20, cuda) == ("spans", "kernels")
    assert kernel_path(342, 342, cuda) == ("spans", "kernels")
    assert kernel_path(MAX_CLASSES + 1, MAX_CLASSES + 1, cuda) == ("spans", "kernels")
    assert kernel_path(1577, 1577, cuda) == ("spans", "kernels")
    assert kernel_path(1577, 19, cuda) == ("spans", "kernels")
    assert kernel_path(1577, 1577, cpu) == ("spans", "autograd")
