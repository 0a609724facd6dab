"""PyTorch / CUDA port of diffgfdn_tpu for NVIDIA Hopper (H100).

``DiffGFDNVarReceiverPos``, fullband and per octave band:

* training: ``training.run_training_var_receiver_pos`` (CLI
  ``python -m diffgfdn_torch.cli.run_model``) trains on a grid of receivers
  through ``training.GFDNTrainer`` and writes JAX-format checkpoints;
  ``cli.run_subband_training`` trains one model per octave band, the bands
  of each architecture group as one step (``parallel.BandParallelTrainer``);
* serving: ``inference.InferDiffGFDN`` reads such a checkpoint and returns
  RIRs at dataset receiver positions (``infer_all_octave_bands`` merges the
  bands into broadband RIRs); ``make_time_domain_synthesis_fn`` synthesizes
  them with no time aliasing.

Both run through the hand-written kernels in ``kernels/`` (``csrc/*.cu``),
forward and backward. Entry points run on CUDA unless the caller passes
``device="cpu"``, where each kernel wrapper takes its plain PyTorch
version. The package never imports JAX or ``diffgfdn_tpu``.
"""
