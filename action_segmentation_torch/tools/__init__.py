"""Measurement tools for the port's kernels, run on a machine with a CUDA card
(``python3 -m action_segmentation_torch.tools.<name> --help``)."""
