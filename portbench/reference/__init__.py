"""The plain references that decide ``correct``: the configurations'
mathematics in plain PyTorch, float32 with TF32 off, computed layer by
layer. They import nothing of `repro_torch`, `repro` or `jax`, and take
no tensor the program made: the harness hands them the weights and
inputs it drew from the seed, and the program's outputs only to judge
them.

``prec="fp8"`` is the control: every product's operands rounded to
float8 (e4m3, one scale a tensor), the rest float32 (`ops.mm`)."""
