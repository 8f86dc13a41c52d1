"""The port's tools (``python3 -m action_segmentation_torch.tools.<name> --help``):
measurements of its kernels, run on a machine with a CUDA card, and the
reference state dict's import and export, which run on the card unless
``main(argv, device="cpu")`` asks for the CPU."""
