"""Model API and the shared training flags.

The abstract ``Model.fit/predict`` contract of the JAX package's
``models/base.py``. The decode slice reads one training flag, ``--seed``;
the optimizer flags and recipe (Adam, the norm clip, the plateau
schedule) and ``mask_grads`` come with the training slice.
"""


def add_training_args(parser):
    parser.add_argument("--seed", type=int, default=1)


class Model:
    """Abstract model interface."""

    @classmethod
    def add_args(cls, parser):
        raise NotImplementedError()

    @classmethod
    def from_args(cls, args, train_data, device=None):
        raise NotImplementedError()

    def fit(self, train_data, use_labels, callback_fn=None):
        raise NotImplementedError()

    def predict(self, test_data):
        raise NotImplementedError()
