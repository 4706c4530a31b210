"""LeNet on (synthetic) Fashion-MNIST — the paper's own experiment (Fig. 1).

Conv(6,5x5)-pool-Conv(16,5x5)-pool-FC120-FC84-FC10, 30 clients x 1500
samples, buffered-async rounds of K=10 [paper §5].
"""
from repro_torch.configs.base import ArchConfig, FLConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="lenet",
        family="vision",
        num_layers=0,
        d_model=0,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=10,  # num classes
    ),
    source="[paper §5: LeNet on Fashion-MNIST, 30 clients x 1500]",
    notes="Conv(6,5x5)-pool-Conv(16,5x5)-pool-FC120-FC84-FC10.",
    skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

PAPER_FL = FLConfig(
    num_clients=30,
    buffer_size=10,
    local_steps=4,
    local_lr=0.05,
    batch_size=32,
    weighting="paper",
)
