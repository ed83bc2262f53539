"""The port's dataset, checkpoint and evaluation tools, each run as
``python -m plankassembly_tpu_torch.tools.<name>`` with the flags of the
JAX package's `tools/<name>.py`:

- `generate_models`, `render_svgs`, `prepare_info`: the offline dataset
  (model JSONs and splits, view SVGs of each variant, info JSONs);
- `robustness_sweep`: one checkpoint over the clean and noisy test sets;
- `export_checkpoint`, `convert_reference_checkpoint`: the released npz
  format and the reference's Lightning checkpoints;
- `build_gt_mesh`, `build_pred_mesh`, `build_html`: meshes and a gallery
  of a test run.
"""
