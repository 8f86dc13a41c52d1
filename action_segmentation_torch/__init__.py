"""PyTorch/CUDA port of the action-segmentation framework.

A PyTorch twin of ``action_segmentation_tpu`` for one NVIDIA H100:
hidden semi-Markov models over pre-extracted video frame features.
Decode (potentials -> Viterbi frame labels or exact spans) and the
training forward/backward run through seven CUDA kernels written by hand
for Hopper, from four sources and one scan template (``csrc/``); the
edit distance of the metrics is a host C++ library built with g++
(``csrc/editdistance.cpp``); everything else is plain PyTorch.

Layout (each file has one twin in the JAX package):
  main.py      the command line (python -m action_segmentation_torch.main)
  api.py       the serving surface (Segmenter, Segmenter.load)
  checkpoint.py  pickles, train-state checkpoints, the reference state dict
  ops/         span codec, semi-Markov DP (plain torch + CUDA kernels),
               emission/duration/transition distributions, sufficient stats
  models/      model classes (semimarkov, the compound model, the flow,
               the BiLSTM encoder; the framewise and sequential baselines)
  data/        synthetic, CrossTask and Breakfast corpora, PCA, batching
  evaluation/  Hungarian-matched accuracy metrics, F1, the edit distance
  parallel/    data parallelism over videos with torch.distributed
  graft_entry.py  the flagship forward step and the multi-rank dry run
  utils/       logging, the deferred label drain, small helpers

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"

BIG_NEG = -1e9

# Parity is defined in fp32: reduced-precision emission matmuls (TF32
# keeps about three decimal digits) move D=300 Gaussian log-likelihoods
# by tenths of a nat, enough to flip near-boundary frame decodes. Pin
# full fp32 for cuBLAS and cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another. Raises when CUDA is asked for (explicitly or by
    default) and no card is present, rather than carrying on quietly on
    the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
