"""Card probes: the fused UConvBlock kernels (``uconv_kernel``, ``hybrid``;
counterparts of ``scripts/probe_uconv_kernel.py`` and
``scripts/probe_hybrid.py``; ``uconv_halves`` times each half alone), the micro-kernels of the block's ops
(``mosaic_ops``, ``mosaic_ops2``; counterparts of
``scripts/probe_mosaic_ops.py`` and ``scripts/probe_mosaic_ops2.py``),
``dw_sites`` (#1 at the served forward's sites), and the training slice's
``dw_backward`` (#1's backward at the recipe's sites) and ``train_step``
(the recipe's step: time, peak memory, profile), the corpus slice's
``train_remat`` (the step under each checkpoint policy; counterpart of
``scripts/probe_train_remat.py``), and the eval slice's
``eval_path`` (the eval and CSS CLIs on the card), and the serving
slice's ``serve_path`` (the engines checked and timed on the card),
``bench_streaming`` and ``bench_async_server`` (counterparts of
``scripts/bench_streaming.py`` and ``scripts/bench_async_server.py``),
the variant family's ``variants`` (the eleven models, their training
and times on the card), the EMCAD-era family's ``era`` (its 22
models, the flagship's training and times), and the deployment slice's
``deploy_path`` (bundles exported, served and held against their models;
its serving half ``deploy_serve`` runs in a fresh interpreter;
``export_parity`` finds the first op where an exported program and its
model part), and the studies slice's ``studies`` (the corpus generator
and the three studies on the card, with #1's launches held exact). Run
each as
``python -m tdanet_tpu_torch.probes.<name> [options]``."""
