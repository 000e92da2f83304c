"""Control ``bfloat16``: the plain reference in float32 arithmetic with
the state stored in bfloat16 after every step, put in the place of a
program whose configuration states float32."""

import numpy as np

from benchmark import compare


def solves(config, traffic, items, program_solve):
    """The control's ``(ys, counters)`` of each pool item."""
    frames, info = compare.reference_solves(
        config, traffic, items, np.float32, storage="bfloat16"
    )
    return [
        (frames[row], {key: int(counts[row]) for key, counts in info.items()})
        for row in range(len(items))
    ]
