"""The serving front of the port: the request balancer and the fixed-batch
admission of solve requests (``repro_torch.serving.balancer``)."""

from repro_torch.serving.balancer import BalancerState, RequestBatch, rebalance

__all__ = ["BalancerState", "RequestBatch", "rebalance"]
