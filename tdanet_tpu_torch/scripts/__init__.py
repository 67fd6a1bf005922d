"""Studies and corpus tools (counterparts of the JAX package's
``scripts/``): ``make_convergence_data`` (the synthetic convergence
corpus), ``probe_early_exit`` (SI-SNRi and RTFx per recurrence depth),
``probe_progressive`` (the adaptive-depth operating curve) and
``probe_act_quant_quality`` (SI-SNRi under 8-bit activation storage).
Run each as ``python -m tdanet_tpu_torch.scripts.<name> [options]``."""
