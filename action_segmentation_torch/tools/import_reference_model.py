"""Import a model trained with the reference (dpfried/action-segmentation)
as a pickle of this port:

    python -m action_segmentation_torch.tools.import_reference_model \
        --state_dict ref_module.pt --output out/all.pkl [model flags...]

`--state_dict` is a torch.save'd state dict of the reference's
SemiMarkovModule (Gaussian) or ComponentSemiMarkovModule (compound),
with its NICE flow and VAE encoder where it has them. The output pickle
loads with ``checkpoint.load_pickle`` / ``Segmenter.load`` and drops into
``--model_input_path``. Model flags (e.g. --sm_max_span_length) follow
the port's command line. The import runs on the card, or where
``main(argv, device=...)`` says; the pickle holds no device.
"""

import argparse
import sys

import torch

from action_segmentation_torch import checkpoint
from action_segmentation_torch.models.base import add_training_args
from action_segmentation_torch.models.semimarkov import (
    SemiMarkovModel,
    semimarkov_from_reference_state_dict,
)


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--state_dict", required=True,
                        help="torch.save'd SemiMarkovModule state_dict")
    parser.add_argument("--output", required=True)
    SemiMarkovModel.add_args(parser)
    add_training_args(parser)
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--annotate_background_with_previous", action="store_true")
    parser.add_argument("--no_merge_classes", action="store_true")
    args = parser.parse_args(argv)
    state_dict = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    model = semimarkov_from_reference_state_dict(args, state_dict, device=device)
    checkpoint.save_pickle(model, args.output)
    print("imported reference model: {} classes, {}-d features -> {}".format(
        model.n_classes, model.feature_dim, args.output))
    return 0


if __name__ == "__main__":
    sys.exit(main())
