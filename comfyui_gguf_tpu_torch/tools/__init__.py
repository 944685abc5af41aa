"""Offline tools of the PyTorch port: convert, quantize, fix_5d_tensors,
fix_lines_ending, read_tensors, validate_checkpoint, read_trace, tp_plan.

Run each as ``python -m comfyui_gguf_tpu_torch.tools.<name> --help``.
"""
