"""The benchmark's weights, drawn from the run's seed on the device.

One ``torch.randn`` call a block (the embedding and head, then each
layer), from one ``torch.Generator`` on the device, in bfloat16 (the type
the configurations serve and train in), then scaled leaf by leaf in
place: a matrix ``[.., in, out]`` by ``in ** -0.5``, the embedding by 1, a
vector (an RMS gain stored as ``1 + g``, a bias) by 0.02.  The same seed
draws the same values again, so the reference regenerates the weights
rather than reading the program's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

Blocks = List[Tuple[str, Dict[str, Tuple[int, ...]]]]


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if name.rsplit(".", 1)[-1] == "embed":
        return 1.0
    return shape[-2] ** -0.5 if len(shape) >= 2 else 0.02


def weight_seed(seed: int) -> int:
    return seed % (1 << 63)


def draw(blocks: Blocks, seed: int, device, dtype=torch.bfloat16
         ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """Yield (block name, {parameter name: tensor}) in ``blocks``' order;
    the tensors of a block are views of one buffer."""
    gen = torch.Generator(device=torch.device(device).type)
    gen.manual_seed(weight_seed(seed))
    for bname, shapes in blocks:
        total = sum(math.prod(s) for s in shapes.values())
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        out, off = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(_std(name, shape))
            off += n
        yield bname, out


@torch.no_grad()
def load_into(params: Dict[str, torch.Tensor], blocks: Blocks, seed: int
              ) -> None:
    """Copy the drawn weights into the program's parameters by name; the
    names and shapes have to match one for one."""
    want = {n: s for _, b in blocks for n, s in b.items()}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        missing = sorted(set(want) ^ set(have))[:8]
        shapes = sorted(n for n in set(want) & set(have)
                        if want[n] != have[n])[:8]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's: names {missing}, shapes {shapes}")
    device = next(iter(params.values())).device
    for _, leaves in draw(blocks, seed, device):
        for n, t in leaves.items():
            params[n].copy_(t)
