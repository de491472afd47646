from .registry import (Model, dense_attn_fn, dense_cache_update,
                       dense_decode_attn)
