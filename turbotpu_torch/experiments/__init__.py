"""The evidence layer: the programs behind every speed and accuracy claim
of the port, counterparts of the JAX package's experiments/ directory and of
experiments/run_acceptance.sh.

* run_acceptance -- C1-C6 through the command line to their stopping rules,
  each point held to results/tpu_accept.jsonl within 4 sigma (`fer_band`);
* accuracy -- nii_window_sweep (window against speed and dB), ext_dtype_ber
  (int8 and fp8 extrinsics), map_variant_ber and map_variant_umts (log-MAP,
  linlog, max-log), seq_nii_ber (the sharded NII decode);
* speed -- flagship_tuning (extrinsic type, spread, batch, MAP variants),
  latency (ms per batch against B), k_sweep (Mbit/s against K, mixed-K
  cost), siso_shapes (the SISO variants per (K, B)), cost_breakdown (where a
  decode's time goes; the issue-rate calibration and roofline of K8),
  gather_inkernel (the row-gather kernel K7), seq_gap and seq_glue (the
  sequence decoder's contract and glue);
* comm_model -- exchange volumes, collective counts and the scaling model
  across cards.

Each program runs as `python -m turbotpu_torch.experiments.<name>` on the
card and writes records/<name>.json (common.py: the card, the commit, its
argv)."""
