"""Card probes of the fused UConvBlock kernels (counterparts of
``scripts/probe_uconv_kernel.py`` and ``scripts/probe_hybrid.py``). Run
each as ``python -m tdanet_tpu_torch.probes.<name> [batch]``."""
