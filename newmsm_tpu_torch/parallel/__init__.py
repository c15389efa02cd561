"""Cohort-scale and multi-GPU optimisation: the groupwise fusion optimiser
subject-sharded over ranks (group_fusion), the row-sharded pairwise cost
volumes (pairwise_sharding), and the ranks and collectives under both
(multihost, over torch.distributed)."""
