"""Card probes: the fused UConvBlock kernels (``uconv_kernel``, ``hybrid``;
counterparts of ``scripts/probe_uconv_kernel.py`` and
``scripts/probe_hybrid.py``; ``uconv_halves`` times each half alone) and the micro-kernels of the block's ops
(``mosaic_ops``, ``mosaic_ops2``; counterparts of
``scripts/probe_mosaic_ops.py`` and ``scripts/probe_mosaic_ops2.py``). Run
each as ``python -m tdanet_tpu_torch.probes.<name> [batch]``."""
