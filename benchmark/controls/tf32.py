"""Control ``tf32``: the program itself with its float32 products in TF32,
for a configuration that states float32 with TF32 off: the port's
``full_fp32_matmul`` blocks switch TF32 on instead of off."""

import contextlib


@contextlib.contextmanager
def tf32_products():
    """Within the block, the program's float32 products run in TF32."""
    import torch
    from pararealml_tpu_torch.ops import linear_propagator

    @contextlib.contextmanager
    def tf32_matmul():
        saved = (
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
        )
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.set_float32_matmul_precision(saved[1])

    original = linear_propagator.full_fp32_matmul
    linear_propagator.full_fp32_matmul = tf32_matmul
    try:
        yield
    finally:
        linear_propagator.full_fp32_matmul = original


def solves(config, traffic, items, program_solve):
    """The control's ``(ys, counters)`` of each pool item."""
    with tf32_products():
        return [program_solve(item) for item in items]
