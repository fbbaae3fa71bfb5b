"""The reference's distribution package on ``torch.distributed``: sharding
rules, the sharding context, expert-parallel MoE and the train, prefill and
decode steps, on one device or over a device mesh."""
