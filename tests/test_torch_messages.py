"""The port's control-plane messages against the JAX package's: the same
classes with the same fields, defaults and field order, the same bytes on
the wire, each side decoding the other's bytes into its own classes, and
both unpicklers refusing what is not a message."""

import dataclasses
import inspect
import io
import pickle
import struct

import numpy as np
import pytest

from dlrover_tpu.common import messages as J
from dlrover_tpu_torch.common import messages as T


def _classes(module):
    return {name: cls for name, cls in vars(module).items()
            if inspect.isclass(cls) and issubclass(cls, module.Message)
            and cls.__module__ == module.__name__
            and dataclasses.is_dataclass(cls)}


JAX_CLASSES = _classes(J)
PORT_CLASSES = _classes(T)
NAMES = sorted(JAX_CLASSES)


def _field_spec(cls):
    spec = []
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = ("factory", f.default_factory())
        spec.append((f.name, f.type, repr(default)))
    return spec


def test_every_jax_message_has_its_port_twin():
    assert len(NAMES) > 60
    assert sorted(PORT_CLASSES) == NAMES
    for name in NAMES:
        assert _field_spec(PORT_CLASSES[name]) == \
            _field_spec(JAX_CLASSES[name]), name
        bases = [b.__name__ for b in PORT_CLASSES[name].__mro__]
        assert bases == [b.__name__ for b in JAX_CLASSES[name].__mro__]


def _random_value(rng, annotation, module):
    """A value of the annotation's type (the annotations the message
    modules use: builtins, Optional/List/Dict of them, and messages)."""
    if annotation.startswith("Optional["):
        if rng.random() < 0.3:
            return None
        return _random_value(rng, annotation[9:-1], module)
    if annotation.startswith("List["):
        inner = annotation[5:-1]
        return [_random_value(rng, inner, module)
                for _ in range(int(rng.integers(0, 4)))]
    if annotation.startswith("Dict["):
        key, value = annotation[5:-1].split(", ")
        return {_random_value(rng, key, module):
                _random_value(rng, value, module)
                for _ in range(int(rng.integers(0, 4)))}
    if annotation == "int":
        return int(rng.integers(-2 ** 40, 2 ** 40))
    if annotation == "float":
        return float(rng.standard_normal() * 10.0 ** rng.integers(-3, 9))
    if annotation == "bool":
        return bool(rng.random() < 0.5)
    if annotation == "str":
        alphabet = "abcxyz/:-_.0123456789 éλ✓"
        return "".join(rng.choice(list(alphabet),
                                  size=int(rng.integers(0, 12))))
    if annotation == "bytes":
        return rng.bytes(int(rng.integers(0, 16)))
    return _random_instance(rng, getattr(module, annotation), module)


def _random_instance(rng, cls, module):
    return cls(**{f.name: _random_value(rng, f.type, module)
                  for f in dataclasses.fields(cls)})


def _twin(instance, module):
    """The same values as an instance of ``module``'s class of that name."""
    cls = getattr(module, type(instance).__name__)
    kwargs = {}
    for f in dataclasses.fields(instance):
        value = getattr(instance, f.name)
        if isinstance(value, list):
            value = [_twin(v, module) if dataclasses.is_dataclass(v) else v
                     for v in value]
        elif dataclasses.is_dataclass(value):
            value = _twin(value, module)
        kwargs[f.name] = value
    return cls(**kwargs)


@pytest.mark.parametrize("seed", range(3))
def test_random_messages_round_trip_to_the_same_bytes(seed):
    rng = np.random.default_rng(seed)
    for name in NAMES:
        port_msg = _random_instance(rng, PORT_CLASSES[name], T)
        jax_msg = _twin(port_msg, J)
        data = T.serialize_message(port_msg)
        assert data == J.serialize_message(jax_msg), name
        back = T.deserialize_message(data)
        assert type(back) is PORT_CLASSES[name] and back == port_msg
        # each side decodes the other's bytes into its own class
        from_jax = T.deserialize_message(J.serialize_message(jax_msg))
        assert type(from_jax) is PORT_CLASSES[name]
        assert dataclasses.asdict(from_jax) == dataclasses.asdict(port_msg)
        to_jax = J.deserialize_message(data)
        assert type(to_jax) is JAX_CLASSES[name]
        assert dataclasses.asdict(to_jax) == dataclasses.asdict(jax_msg)


def test_default_messages_are_the_same_bytes():
    for name in NAMES:
        assert T.serialize_message(PORT_CLASSES[name]()) == \
            J.serialize_message(JAX_CLASSES[name]()), name
    assert T.deserialize_message(b"") is None


def _global_payload(module: str, name: str) -> bytes:
    """A pickle that only names ``module.name`` (protocol 4)."""
    out = io.BytesIO()
    out.write(b"\x80\x04")
    for text in (module, name):
        raw = text.encode()
        out.write(b"\x8c" + struct.pack("<B", len(raw)) + raw)
    out.write(b"\x93.")   # STACK_GLOBAL, STOP
    return out.getvalue()


@pytest.mark.parametrize("payload", [
    pickle.dumps(__import__("collections").OrderedDict(a=1)),
    _global_payload("os", "system"),
    _global_payload("builtins", "eval"),
    # a dotted name walks attributes from an allowed module
    _global_payload("dlrover_tpu.common.messages", "Response.__init__"),
    _global_payload("builtins", "dict.fromkeys"),
    # only the wire module names messages; the port's own module does not
    _global_payload("dlrover_tpu_torch.common.messages", "Response"),
    # a name in the wire module that is not a message class
    _global_payload("dlrover_tpu.common.messages", "pickle"),
], ids=["foreign-class", "os-system", "eval", "dotted-message",
        "dotted-builtin", "port-module", "non-message"])
def test_both_unpicklers_refuse_what_is_not_a_message(payload):
    for module in (T, J):
        with pytest.raises(pickle.UnpicklingError):
            module.deserialize_message(payload)
