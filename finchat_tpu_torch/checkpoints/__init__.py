"""Checkpoints for the port: its own safetensors reader and writer, the
HuggingFace Llama and BERT loaders, and native save/restore of parameter
trees and train states. No HuggingFace package is needed at run time."""

from finchat_tpu_torch.checkpoints.hf_loader import load_llama_params

__all__ = ["load_llama_params"]
