"""Sequential models: their command-line flags only.

Twin of the JAX package's ``models/sequential.py``. The four classes
declare the same flags, so the command line accepts every flag the JAX
package's does; their models are not ported yet (ROADMAP.md §1 item 9),
and ``from_args`` raises rather than train something else.
"""

from action_segmentation_torch.models.framewise import _Unported


def encoder_args(parser):
    parser.add_argument("--seq_num_layers", type=int, default=2)


class SequentialDiscriminative(_Unported):
    @classmethod
    def add_args(cls, parser):
        encoder_args(parser)
        parser.add_argument("--seq_hidden_size", type=int, default=200)


class SequentialCanonicalBaseline(_Unported):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--canonical_baseline_background_fraction", type=float, default=0.0
        )


class SequentialPredictConstraints(_Unported):
    pass


class SequentialGroundTruth(_Unported):
    pass
