"""Data substrate: seeded synthetic datasets, real-dataset ingestion
(svmlight/CSV -> packed bucket-tile cache -> streamed epochs) and the
dataset registry, and the LM token pipeline (`loader`: the seeded
Markov-chain stream and the hierarchical batcher)."""
from .synthetic import (criteo_like, epsilon_like, higgs_like,
                        make_dense_classification, make_dense_regression,
                        make_sparse_classification)
from .formats import (dump_csv, dump_svmlight, parse_csv, parse_svmlight,
                      to_dense)
from .cache import (ArrayFeed, TileCache, TileFeed, build_cache,
                    open_cache)
from .registry import (REGISTRY, Dataset, DatasetSpec, get_dataset,
                       get_spec, materialize)
from .loader import ShardedBatcher, lm_token_batches, markov_batch

__all__ = [
    "criteo_like", "epsilon_like", "higgs_like",
    "make_dense_classification", "make_dense_regression",
    "make_sparse_classification",
    "dump_csv", "dump_svmlight", "parse_csv", "parse_svmlight",
    "to_dense",
    "ArrayFeed", "TileCache", "TileFeed", "build_cache", "open_cache",
    "REGISTRY", "Dataset", "DatasetSpec", "get_dataset", "get_spec",
    "materialize",
    "ShardedBatcher", "lm_token_batches", "markov_batch",
]
