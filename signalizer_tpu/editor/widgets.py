"""Widget models: controller layouts resolved to concrete live widgets.

The SignalizerDesign kit's job (ref: Source/Common/SignalizerDesign.{h,cpp}
— ``CContentPage`` icon-tab pages holding ``MatrixSection`` grids that bind
cpl widgets to parameters, :178-299) split this way: the page
*structure* lives in :mod:`signalizer_tpu.views.controllers` as data, and
this module resolves each referenced name against a live Content's
registered parameters into a renderable widget descriptor — kind, current
value, display text, options — that any UI (the shipped browser editor,
an embedder's own toolkit) can draw and bind.

Widget kinds mirror the reference's control taxonomy
(SpectrumController.cpp:262-367 instantiates exactly these):

  ``knob``    a continuous parameter — normalized slider + editable text
  ``combo``   a ChoiceFormatter parameter (ref: CComboBox binding)
  ``toggle``  a boolean parameter (ref: CButton binding)
  ``colour``  an RGBA ColourValue bundle (ref: ColourControl)
  ``bundle``  a composite value (DspWin window designer / Slope) shown as
              its sub-widgets in one cell (ref: DSPWindowWidget/PowerSlopeWidget)
  ``presets`` the preset load/save widget (ref: PresetWidget)

Parameter edits have three *consequence tiers*, mirroring the reference's
split between knobs the DSP reads per frame and shape changes that go
through ``handleFlagUpdates`` (SpectrumDSP.cpp handleFlagUpdates; the
editor never rebuilds for a colour drag):

  ``rebuild`` the view's processor must be rebuilt (Constant/kwargs/
              engine-factory consumers)
  ``feed``    only render feeds/trackers rebuild (no DSP state loss)
  ``render``  read per frame from make_render_hints(); nothing rebuilds

The tier tables are cross-checked mechanically against the knob-inventory
consumer map (tests/test_editor_widgets.py) so a knob can't silently land
in the wrong tier.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from signalizer_tpu.params.parameters import (
    BooleanRange,
    ChoiceFormatter,
    Parameter,
)
from signalizer_tpu.views.controllers import Control, layout_for

__all__ = [
    "describe_parameter",
    "resolve_control",
    "describe_pages",
    "tier_of",
    "TIERS",
]


def describe_parameter(p: Parameter) -> Dict:
    """One live parameter -> widget descriptor."""
    d: Dict = {
        "name": p.name,
        "exported": p.exported_name,
        "normalized": p.get_normalized(),
        "display": p.get_display_text(),
    }
    if isinstance(p.formatter, ChoiceFormatter):
        d["kind"] = "combo"
        d["options"] = list(p.formatter.options)
        d["index"] = int(round(p.get_transformed()))
    elif isinstance(p.transformer, BooleanRange):
        d["kind"] = "toggle"
        d["on"] = p.get_transformed() > 0.5
    else:
        d["kind"] = "knob"
    return d


def resolve_control(parameter_set, control: Control) -> Optional[Dict]:
    """Resolve one layout Control against a live ParameterSet."""
    if control.special:
        return {"kind": control.special, "name": control.special, "column": control.column}
    exact = parameter_set.find(control.name)
    if exact is not None:
        d = describe_parameter(exact)
        d["column"] = control.column
        return d
    prefix = control.name + "."
    members = [p for p in parameter_set if p.name.startswith(prefix)]
    if not members:
        return None
    suffixes = {p.name[len(prefix):] for p in members}
    if suffixes == {"R", "G", "B", "A"}:
        by = {p.name[len(prefix):]: p for p in members}
        rgba = [by[k].get_transformed() for k in ("R", "G", "B", "A")]
        return {
            "kind": "colour",
            "name": control.name,
            "column": control.column,
            "rgba": rgba,
        }
    return {
        "kind": "bundle",
        "name": control.name,
        "column": control.column,
        "members": [describe_parameter(p) for p in members],
    }


def describe_pages(content) -> List[Dict]:
    """A Content's full editor model: pages -> sections -> live widgets."""
    ps = content.parameter_set
    pages = []
    for page in layout_for(content):
        sections = []
        for section in page.sections:
            controls = [resolve_control(ps, c) for c in section.controls]
            sections.append(
                {"name": section.name, "controls": [c for c in controls if c]}
            )
        pages.append({"name": page.name, "icon": page.icon, "sections": sections})
    return pages


# ---------------------------------------------------------------------------
# consequence tiers
# ---------------------------------------------------------------------------
# Base names (layout Control names) per view whose edits rebuild processors
# ("rebuild") or only render feeds ("feed"); everything else is read per
# frame through make_render_hints() ("render"). Mirrors the consumer map in
# tests/test_knob_inventory.py: constant:/kwargs:/engine: -> rebuild,
# feed:/tracker: -> feed, render:/host: -> render.

TIERS: Dict[str, Dict[str, set]] = {
    "Spectrum": {
        "rebuild": {
            "ViewScaling", "Algorithm", "ChannelConfiguration", "DisplayMode",
            "BinInterpolation", "LowerBound", "UpperBound", "WindowSize",
            "BlobSize", "FrameSmoothing", "SpectrumStretch", "FreeQ",
            "ViewLeft", "ViewRight", "DspWin", "Slope",
            "Line0Decay", "Line1Decay",
            *{f"Grad{i}" for i in range(5)},
            *{f"GradRatio{i}" for i in range(5)},
        },
        "feed": {
            "PrimitiveSize", "FloodFillAlpha", "RefTuning", "FTracker",
            "TrackerSmoothing", "ShowLegend", "Grid", "Bck",
            "Line0One", "Line0Two", "Line1One", "Line1Two",
        },
    },
    "Oscilloscope": {
        "rebuild": {
            "EnvelopeWindow", "InputGain", "WindowSize", "TriggerPhase",
            "CustomTrigger", "CustomTriggerFrequency", "ColourSmoothing",
            "FColourBlend", "THysteresis", "TThreshold", "TriggeringChannel",
            "AutoGain", "ChannelConfiguration", "SampleInterpolation",
            "TriggerMode", "TimeMode", "ChannelColouring",
            "PrimaryColour", "SecondaryColour",
            "LowColour", "MidColour", "HighColour",
        },
        "feed": set(),
    },
    "Vectorscope": {
        "rebuild": {
            "EnvelopeWindow", "StereoWindow", "InputGain", "WaveZRotation",
            "ScalePolarModeToFill", "AutoGain", "OperationalMode",
        },
        "feed": set(),
    },
}


def tier_of(view_name: str, base_name: str) -> str:
    """The consequence tier of editing ``base_name`` on view ``view_name``.

    ``base_name`` may be a full parameter name ("Grid.R") — bundle members
    classify by their bundle's base.
    """
    tiers = TIERS.get(view_name, {})
    base = base_name.split(".", 1)[0]
    if base in tiers.get("rebuild", ()):
        return "rebuild"
    if base in tiers.get("feed", ()):
        return "feed"
    return "render"
