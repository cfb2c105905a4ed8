"""Model modules of the port (SigLIP towers, HICom projector, Qwen2 decoder)."""
