"""The paper's own workload config: batched Hessian-vector products on the
Rosenbrock / Ackley / Fletcher-Powell families (paper §7).

Not an LM -- this drives the HVP-service example, the GPU-level benchmarks
(Figs. 10-12, Tables 1-3) and the chess_hvp Pallas kernel.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ChessfadConfig:
    function: str = "rosenbrock"      # rosenbrock | ackley | fletcher_powell
    n: int = 16                       # number of variables
    csize: int = 4                    # chunk size (paper csize)
    instances: int = 500_000          # paper: 0.5M data points on A100
    level: str = "L2"                 # L0 | L1 | L2 parallel schedule
    symmetric: bool = False
    dtype: str = "float32"


def config() -> ChessfadConfig:
    return ChessfadConfig()


def reduced_config() -> ChessfadConfig:
    return ChessfadConfig(n=8, csize=2, instances=64)
