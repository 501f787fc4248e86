"""DDPG agent (counterpart of pocketflow_tpu/rl_agents/ddpg)."""
