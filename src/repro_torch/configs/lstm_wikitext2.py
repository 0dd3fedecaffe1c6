"""The paper's own WikiText-2 LSTM LM (Table III: 84.98M params).

``CONFIG`` is the full published width; ``REDUCED`` is the small variant the
serve CLI runs without ``--full`` (hidden 192, vocab 4000), as the
reference CLI does."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="lstm_wikitext2", family="lstm",
    n_layers=2, d_model=1024, vocab=33278, rope="none", tie_embeddings=True,
    source="paper Table III (WikiText-2, 84.98M params)",
    notes="2-layer LSTM hidden 1024, tied embeddings: 33278*1024*2 + 2*8*1024^2 ~= 85M.",
)

REDUCED = dataclasses.replace(CONFIG, d_model=192, vocab=4000)
