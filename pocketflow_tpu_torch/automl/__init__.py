from pocketflow_tpu_torch.automl.search import (GPSearch, ParamSpec, RandomSearch,
                                                run_automl)

__all__ = ['GPSearch', 'ParamSpec', 'RandomSearch', 'run_automl']
