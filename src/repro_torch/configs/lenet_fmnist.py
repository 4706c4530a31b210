"""LeNet on (synthetic) Fashion-MNIST — the paper's own experiment (Fig. 1).

Conv(6,5x5)-pool-Conv(16,5x5)-pool-FC120-FC84-FC10, 30 clients x 1500
samples, buffered-async rounds of K=10 [paper §5].
"""
from repro_torch.configs.base import FLConfig

PAPER_FL = FLConfig(
    num_clients=30,
    buffer_size=10,
    local_steps=4,
    local_lr=0.05,
    batch_size=32,
    weighting="paper",
)
