"""Frozen copies of the port's modules (gaussianip_tpu_torch) as the
benchmark's plain reference: float32, one process, and plain PyTorch in
place of each kernel: F.conv2d for K3 (ops/conv3x3.py), the plain tile
compositor for K1 / K2 (render/composite_cuda.py) and written-out attention
for F.scaled_dot_product_attention (diffusion/blocks.py). `lowp.quantised`
switches the conv and dense layers to the control's float8 rounding.
Relative imports only: nothing here imports the port."""
