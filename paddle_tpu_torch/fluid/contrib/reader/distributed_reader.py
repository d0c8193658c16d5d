"""Round-robin batch sharding for multi-process training
(ref: python/paddle/fluid/contrib/reader/distributed_reader.py).

Each trainer keeps every trainers_num-th batch of the shared stream —
trainer k takes batches k, k+N, k+2N, … The worker identity comes from
the same PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID env vars the launcher
(distributed/launch.py) exports, so reference training scripts shard
identically here. Port of
paddle_tpu/fluid/contrib/reader/distributed_reader.py.
"""
import itertools
import os

__all__ = ["distributed_batch_reader"]


def distributed_batch_reader(batch_reader):
    """Wrap a batch reader so each trainer consumes a disjoint 1/N slice
    (round-robin by batch index). A trailing partial round — fewer
    batches than trainers — is dropped on every worker, keeping step
    counts identical across the fleet (collectives stay in lockstep)."""
    trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    if trainer_id >= trainers_num:
        raise ValueError(
            "PADDLE_TRAINER_ID=%d out of range for PADDLE_TRAINERS_NUM=%d"
            % (trainer_id, trainers_num)
        )

    def sharded():
        if trainers_num == 1:
            yield from batch_reader()
            return
        it = iter(batch_reader())
        while True:
            round_batches = list(itertools.islice(it, trainers_num))
            if len(round_batches) < trainers_num:
                return  # partial round: dropped everywhere, steps align
            yield round_batches[trainer_id]

    return sharded
