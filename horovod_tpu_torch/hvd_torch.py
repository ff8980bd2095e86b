"""User-facing API: DistributedOptimizer and the startup broadcasts.

The port of ``horovod_tpu/hvd_jax.py``'s ``DistributedOptimizer``,
``broadcast_variables`` and ``broadcast_optimizer_state`` in Horovod's
PyTorch form: ``DistributedOptimizer`` wraps a ``torch.optim`` optimizer,
and its ``step()`` averages the parameters' ``.grad`` across ranks through
the fused buckets before the inner step. Unlike the JAX optimizer, which
returns new state, everything here updates in place: the gradients, the
parameters and the inner optimizer's state.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops.reduction import Average
from horovod_tpu_torch.parallel import mesh as mesh_lib


class DistributedOptimizer:
    """Wrap ``optimizer`` so every ``step()`` first allreduces (``op``,
    Average by default) the gradients of ``named_parameters`` (by default
    every parameter of the optimizer, in its order) in fused buckets of
    at most ``HOROVOD_FUSION_THRESHOLD`` bytes. A parameter without a
    gradient takes part with zeros, so every rank sends the same buckets.

    ``last_buckets`` holds the buckets of the latest exchange."""

    def __init__(self, optimizer, named_parameters=None, op=Average):
        self.optimizer = optimizer
        self.op = op
        if named_parameters is None:
            params = [p for group in optimizer.param_groups
                      for p in group["params"]]
        else:
            params = [p for _, p in named_parameters]
        owned = {id(p) for group in optimizer.param_groups
                 for p in group["params"]}
        if any(id(p) not in owned for p in params):
            raise ValueError("named_parameters holds a parameter the "
                             "optimizer does not update")
        self._params = params
        self.last_buckets = ()

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def synchronize(self):
        """Allreduce the gradients in place."""
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.last_buckets = tuple(fusion.fused_allreduce_(
            [p.grad for p in self._params], op=self.op))

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DistributedOptimizer.step takes no closure: "
                             "compute the loss and backward first")
        self.synchronize()
        return self.optimizer.step()


@torch.no_grad()
def broadcast_parameters(state_dict, root_rank=0):
    """Overwrite, in place, every tensor of ``state_dict`` with rank
    ``root_rank``'s, in the order of the names."""
    for name in sorted(state_dict):
        collective.broadcast_(state_dict[name], root_rank=root_rank)


@torch.no_grad()
def broadcast_optimizer_state(optimizer, root_rank=0):
    """Overwrite, in place, the optimizer's per-parameter state tensors
    and its hyperparameters with rank ``root_rank``'s. Tensors that live
    off this process's device (e.g. AdamW's ``step`` on the CPU) travel
    through the device and are copied back."""
    opt = getattr(optimizer, "optimizer", optimizer)
    m = mesh_lib.get_mesh()
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.param_groups]
    obj = [groups]
    dist.broadcast_object_list(obj, src=root_rank, group=m.group,
                               device=m.device)
    for g, src in zip(opt.param_groups, obj[0]):
        g.update(src)
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        for key in sorted(opt.state.get(p, {})):
            v = opt.state[p][key]
            if not torch.is_tensor(v):
                continue
            tmp = v.to(m.device)
            collective.broadcast_(tmp, root_rank=root_rank)
            if tmp is not v:
                v.copy_(tmp)
