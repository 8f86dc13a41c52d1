"""Export a model pickled by this port as a state dict the reference
loads (the inverse of ``tools/import_reference_model.py``):

    python -m action_segmentation_torch.tools.export_reference_model \
        --model expts/.../all.pkl --output ref_module.pt

The output loads into the reference's SemiMarkovModule or
ComponentSemiMarkovModule with ``module.load_state_dict(torch.load(f))``.
The pickle is read onto the card, or where ``main(argv, device=...)``
says.
"""

import argparse
import sys

import torch

from action_segmentation_torch import checkpoint


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", required=True, help="a model pickle of this port")
    parser.add_argument("--output", required=True, help="torch state_dict path")
    args = parser.parse_args(argv)
    model = checkpoint.load_pickle(args.model, device=device)
    sd = checkpoint.reference_state_dict_from_params(model.module.state_dict())
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, args.output)
    print("exported {} tensors -> {}".format(len(sd), args.output))
    return 0


if __name__ == "__main__":
    sys.exit(main())
