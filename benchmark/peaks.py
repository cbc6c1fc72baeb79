"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline and mfu metric."""

FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
BYTES_PER_S = 3.35e12
