"""RunningApp: server-side identity of an in-flight app run (port of
modal_tpu/running_app.py; reference py/modal/running_app.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .proto import api_pb2


@dataclass
class RunningApp:
    app_id: str
    app_page_url: Optional[str] = None
    function_ids: dict[str, str] = field(default_factory=dict)
    class_ids: dict[str, str] = field(default_factory=dict)
    interactive: bool = False


def running_app_from_layout(app_id: str, layout: api_pb2.AppLayout) -> RunningApp:
    function_ids = {}
    class_ids = {}
    for tag, object_id in layout.objects.items():
        if object_id.startswith("fu-"):
            function_ids[tag] = object_id
        elif object_id.startswith("cs-"):
            class_ids[tag] = object_id
    return RunningApp(app_id=app_id, function_ids=function_ids, class_ids=class_ids)
