"""Cohort-scale optimisation: the groupwise fusion optimiser on one device
(all subjects batched on the card)."""
