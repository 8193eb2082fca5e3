"""JointλObject — the cloud event object carrying data + control (paper §3.3).

Format (Fig 4), serialized as a plain dict so it can cross any FaaS HTTP
boundary:

    {
      "Control": {workflowId, step, branch, iter},
      "Data":    {"direct": <value>}                       # inline payload
               | {"indirect": true, "ds": <id>, "keys": [<output keys>]},
      "Meta":    {source, fanin_size, ...}                  # free-form hints
    }

``Unwrap`` extracts the user input (pulling indirect data from the datastore
— which doubles as the upstream output checkpoint); ``Wrap`` builds the
object for each subsequent invocation.  Both live in the orchestrator; this
module owns the representation and the direct/indirect decision (§4.3.1:
direct transfer when the payload fits the target FaaS async quota, indirect
via datastore otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.backends.simcloud import estimate_size
from repro_torch.core.naming import Control

# metadata overhead of the envelope itself when sizing against quotas
ENVELOPE_BYTES = 512


@dataclass
class JLObject:
    control: Control
    data: Dict[str, Any] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    # ---- payload views --------------------------------------------------------

    @property
    def is_indirect(self) -> bool:
        return bool(self.data.get("indirect"))

    @property
    def direct_value(self) -> Any:
        return self.data.get("direct")

    @property
    def indirect_keys(self) -> List[str]:
        return list(self.data.get("keys", ()))

    @property
    def indirect_ds(self) -> Optional[str]:
        return self.data.get("ds")

    # ---- construction -----------------------------------------------------------

    @staticmethod
    def direct(control: Control, value: Any, meta: Optional[dict] = None) -> "JLObject":
        return JLObject(control, {"direct": value}, meta or {})

    @staticmethod
    def indirect(control: Control, ds: str, keys: Sequence[str],
                 meta: Optional[dict] = None) -> "JLObject":
        return JLObject(control, {"indirect": True, "ds": ds, "keys": list(keys)},
                        meta or {})

    # ---- wire format ---------------------------------------------------------------

    def to_event(self) -> dict:
        return {"Control": self.control.to_dict(), "Data": self.data, "Meta": self.meta}

    @staticmethod
    def from_event(event: dict) -> "JLObject":
        return JLObject(Control.from_dict(event["Control"]),
                        dict(event.get("Data", {})), dict(event.get("Meta", {})))

    def wire_size(self) -> int:
        return ENVELOPE_BYTES + estimate_size(self.data)


def fits_quota(value: Any, quota: int) -> bool:
    """Would a direct transfer of ``value`` fit the target's async quota?"""
    return ENVELOPE_BYTES + estimate_size(value) <= quota
