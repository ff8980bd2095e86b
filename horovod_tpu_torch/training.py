"""Training-step builders: the Horovod programming model in PyTorch.

The port of ``horovod_tpu/training.py``'s ``softmax_cross_entropy``,
``create_train_state`` and ``make_lm_train_step`` (the data-parallel path
without sequence sharding). The JAX step is a pure function returning a
new ``TrainState``; here the step runs eagerly on this process's shard of
the batch and updates the model's parameters and the optimizer's state
in place.
"""

import torch
import torch.nn.functional as F

from horovod_tpu_torch import hvd_torch
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy with integer labels (fp32 log-softmax)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def create_train_state(model, optimizer, root_rank=0):
    """Make every rank's replica start from ``root_rank``'s parameters and
    optimizer state (in place)."""
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=root_rank)
    hvd_torch.broadcast_optimizer_state(optimizer, root_rank=root_rank)


def make_lm_train_step(model, optimizer):
    """Build a language-model train step (next-token loss) over the data
    axis. ``optimizer`` is a ``DistributedOptimizer``; ``step(tokens)``
    takes this rank's ``[B_local, S]`` int tokens, runs forward, backward
    and the optimizer step, and returns the loss averaged over ranks (an
    fp32 scalar tensor on the device).

    The loss is normalized by the GLOBAL target count: the local sum is
    scaled by ``world / global_count``, so that averaging the per-rank
    losses and gradients gives the exact global-mean loss and gradient
    even when ranks hold different numbers of targets."""
    if not isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise TypeError("make_lm_train_step needs a DistributedOptimizer")
    mesh = mesh_lib.get_mesh()

    def step(tokens):
        tokens = tokens.to(mesh.device)
        targets = tokens[:, 1:]
        optimizer.zero_grad(set_to_none=True)
        local_count = torch.tensor(float(targets.numel()), device=mesh.device)
        global_count = collective.allreduce_(local_count.clone(), op=Sum)
        local_mean = softmax_cross_entropy(model(tokens)[:, :-1], targets)
        loss = local_mean * local_count * mesh.size / global_count
        loss.backward()
        optimizer.step()  # Average-allreduces the gradients first
        return collective.allreduce_(loss.detach(), op=Average)

    return step
