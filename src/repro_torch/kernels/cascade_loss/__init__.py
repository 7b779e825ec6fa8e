"""K4 and K5: the fused L3 training-step reductions and their backward
(`kernel.py` wraps `csrc/cascade_loss.cu`; `ref.py` holds the plain PyTorch
forward and the closed-form backward)."""
