"""Data substrate: seeded synthetic datasets, real-dataset ingestion
(svmlight/CSV -> packed bucket-tile cache -> streamed epochs) and the
dataset registry.  The reference's LM token pipeline (`loader`) waits on
ROADMAP A16."""
from .synthetic import make_dense_classification, make_sparse_classification
from .formats import (dump_csv, dump_svmlight, parse_csv, parse_svmlight,
                      to_dense)
from .cache import (ArrayFeed, TileCache, TileFeed, build_cache,
                    open_cache)
from .registry import (REGISTRY, Dataset, DatasetSpec, get_dataset,
                       get_spec, materialize)

__all__ = [
    "make_dense_classification", "make_sparse_classification",
    "dump_csv", "dump_svmlight", "parse_csv", "parse_svmlight",
    "to_dense",
    "ArrayFeed", "TileCache", "TileFeed", "build_cache", "open_cache",
    "REGISTRY", "Dataset", "DatasetSpec", "get_dataset", "get_spec",
    "materialize",
]
