"""Typed-array annotations for the public API (PyTorch counterpart of
``worldrenderer_tpu/utils/typing.py``): the common typing names and, when
installed, jaxtyping's dtype/shape annotations, which check
``torch.Tensor``s as well (jaxtyping itself imports no JAX).
"""

from typing import (  # noqa: F401
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Literal,
    NamedTuple,
    NewType,
    Optional,
    Sequence,
    Sized,
    Tuple,
    Type,
    TypeVar,
    Union,
)

try:
    from jaxtyping import (  # noqa: F401
        Bool,
        Complex,
        Float,
        Inexact,
        Int,
        Integer,
        Num,
        Shaped,
        UInt,
        jaxtyped,
    )

    HAS_JAXTYPING = True
except ImportError:  # pragma: no cover
    HAS_JAXTYPING = False
