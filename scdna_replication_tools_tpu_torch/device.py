"""Device policy of the port's entry points.

``scRT``, ``PertInference`` and ``fit_map`` run on ``cuda`` unless the
caller asks for the CPU.  With no device given and no GPU present they
raise: a fit never continues on the CPU by accident.  A rank of a
sharded fit (``parallel.init_distributed``) given no device takes the
card ``local_rank % device_count``: two ranks on a one-card machine
share ``cuda:0``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU and raises when there is none (in a process
    group, this rank's card, made current for the kernels' launches);
    ``'cpu'`` and ``'cuda[:n]'`` are taken as given.  Also pins float32 matmuls and
    convolutions to full float32: the GC polynomial, the Pearson
    matrices and the composite prior are float32 products, and TF32
    keeps only about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        from scdna_replication_tools_tpu_torch.parallel.distributed import (
            local_rank,
            process_rank_and_count,
        )
        if process_rank_and_count()[1] > 1:
            index = local_rank() % torch.cuda.device_count()
            torch.cuda.set_device(index)
            return torch.device("cuda", index)
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or "
                         "'cpu'")
    return dev
