"""Framewise classifiers: their command-line flags only.

Twin of the JAX package's ``models/framewise.py``. The three classes
declare the same flags, so the command line accepts every flag the JAX
package's does; their models are not ported yet (ROADMAP.md §1 item 9),
and ``from_args`` raises rather than train something else.
"""

from action_segmentation_torch.models.base import Model

_BASELINES = "baseline classifiers are not ported yet (ROADMAP.md §1 item 9)"


def feed_forward_args(parser):
    parser.add_argument("--ff_dropout_p", type=float, default=0.1)
    parser.add_argument("--ff_hidden_layers", type=int, default=0)
    parser.add_argument("--ff_hidden_dim", type=int, default=200)


class _Unported(Model):
    @classmethod
    def add_args(cls, parser):
        pass

    @classmethod
    def from_args(cls, args, train_data, device=None):
        raise NotImplementedError("{}: {}".format(cls.__name__, _BASELINES))


class FramewiseDiscriminative(_Unported):
    @classmethod
    def add_args(cls, parser):
        feed_forward_args(parser)


class FramewiseGaussianMixture(_Unported):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--gm_covariance",
            choices=["full", "diag", "tied", "tied_diag"],
            default="tied_diag",
        )


class FramewiseBaseline(_Unported):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument(
            "--framewise_baseline_type",
            choices=["majority_class", "sample_class_distribution"],
        )
