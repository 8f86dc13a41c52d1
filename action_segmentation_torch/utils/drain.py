"""Deferred label drain: the dispatch/fetch discipline for decode loops.

Decode loops launch every batch asynchronously and keep its label
tensor on the device; one stacked copy to the host at the end waits for
all of them. A per-batch ``.cpu()`` would stall the host on every batch
and leave the card idle while the next batch is prepared. Both serving
(``api.Segmenter.segment_many``) and ``SemiMarkovModel.predict`` use
this one helper.
"""

import torch
import torch.nn.functional as F


class DeferredLabelDrain:
    """Collects per-batch device label tensors; fetches them all at once.

    add(meta, labels, n_rows): register one launched batch. `meta` is
    opaque caller context (video names, indices, lengths); `n_rows`
    trims padded rows (defaults to all rows). Nothing here waits for
    the device.

    drain(): pads every batch's labels to the common max T with -1,
    concatenates on the device, copies the stack to the host ONCE, and
    yields (meta, labels (n_rows, t_max) np.ndarray) in add() order.
    """

    def __init__(self):
        self._items = []  # (meta, labels, n_rows)

    def add(self, meta, labels, n_rows=None):
        n = int(n_rows) if n_rows is not None else int(labels.shape[0])
        self._items.append((meta, labels, n))

    def drain(self):
        if not self._items:
            return
        t_max = max(lab.shape[1] for _, lab, _ in self._items)
        stacked = torch.cat(
            [
                F.pad(lab[:n], (0, t_max - lab.shape[1]), value=-1)
                for _, lab, n in self._items
            ],
            dim=0,
        )
        all_labels = stacked.cpu().numpy()  # the single fetch
        row = 0
        for meta, _, n in self._items:
            yield meta, all_labels[row : row + n]
            row += n
        self._items = []
