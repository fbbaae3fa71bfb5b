"""The paper's own experiment model: LR for CTR on (synthetic) Avazu."""
import dataclasses

@dataclasses.dataclass(frozen=True)
class CTRConfig:
    name: str = "avazu-lr"
    dim: int = 256
    lr: float = 1e-3          # paper §VI.A.1
    local_epochs: int = 10    # paper §VI.A.1

CONFIG = CTRConfig()
SMOKE_CONFIG = dataclasses.replace(CONFIG, dim=32)
