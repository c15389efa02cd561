"""Cohort pipelines: gMSM / cgMSM group runs, dedrifting, and the cluster-tree
bookkeeping that drives them."""
