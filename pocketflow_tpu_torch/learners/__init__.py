"""Learners: the compression algorithms as transformations of a train state."""

from pocketflow_tpu_torch.learners.learner_utils import create_learner  # noqa: F401
