# The paper's primary contribution: GBA / GBATC / GAE compression with
# guaranteed error bounds.
from repro_torch.core.blocking import BlockGeometry, PAPER_GEOMETRY  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    GBATCPipeline,
    PipelineConfig,
    CompressionReport,
)
