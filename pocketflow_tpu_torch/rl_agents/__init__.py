"""RL agents for hyper-parameter search (counterpart of pocketflow_tpu/rl_agents)."""
