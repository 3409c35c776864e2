"""Rule-based caption synthesis from SynFMC metadata (the port's copy of
synfmc_tpu/data/captions.py, reading masks through ``data/image.py``).

Functionally equivalent rebuild of the reference caption machinery
(fmc/data/dataset.py:25-46 background, 248-381 visible objects/actions,
752-878 camera-type classification, 981-1204 template families,
2217-2270 enter/exit/then families, 2571-2670 per-object sentences,
4815-5155 keyframe caption assembly, utils.py:122-142 verb morphology).

Template *machinery* — family sizes, RNG-driven selections, adj/no-adj
split, a/the choice, view-point word subsets, enter/exit/then narration,
action-change narration for tracked objects, the 90% synthetic-descriptor
wrap (applied to the background caption too) — matches the reference
structure one-for-one.  Phrasings are our own, with one deliberate
exception: ``DESCRIPTOR_TEMPLATE`` is adopted verbatim (see its comment).
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

from synfmc_tpu_torch.data.masks import is_normal_size


# ---------------------------------------------------------------------------
# small parsing / morphology helpers (fmc/data/utils.py)
# ---------------------------------------------------------------------------


def csv_param_to_dict(param: str, split: str = ";") -> dict:
    """Parse 'k=v;k2=v2' Comment fields (utils.py:34-46)."""
    out = {}
    for item in param.split(split):
        if not item:
            continue
        key, _, value = item.partition("=")
        out[key] = value
    return out


def present_continuous(verb: str) -> str:
    """-ing form (utils.py:122-133)."""
    if verb.endswith("ie"):
        return verb[:-2] + "ying"
    if verb.endswith("e") and len(verb) > 2 and verb[-2] != "e":
        return verb[:-1] + "ing"
    if (
        len(verb) >= 3
        and verb[-1] not in "aeiou"
        and verb[-2] in "aeiou"
        and verb[-3] not in "aeiou"
    ):
        return verb + verb[-1] + "ing"
    return verb + "ing"


def third_person_singular(verb: str) -> str:
    """-s form (utils.py:136-142)."""
    if verb.endswith("y") and verb[-2] not in "aeiou":
        return verb[:-1] + "ies"
    if verb.endswith(("s", "sh", "ch", "x", "z", "o")):
        return verb + "es"
    return verb + "s"


_IRREGULAR_VERB_BASE = {
    # inflected -> base, for the handful of motion verbs the dataset uses
    "ran": "run", "running": "run", "runs": "run",
    "flew": "fly", "flies": "fly", "flying": "fly",
    "swam": "swim", "swum": "swim", "swimming": "swim", "swims": "swim",
    "left": "leave", "leaves": "leave",
    "lay": "lie", "lying": "lie", "lies": "lie",
    "sat": "sit", "sitting": "sit", "sits": "sit",
    "stood": "stand", "standing": "stand", "stands": "stand",
    "dove": "dive", "diving": "dive", "dives": "dive",
    "hopped": "hop", "hopping": "hop", "hops": "hop",
}

_CONSONANTS = "bcdfghjklmnpqrstvwz"


def lemmatize_verb(verb: str) -> str:
    """Rule-based verb lemmatizer replacing the reference's nltk
    WordNetLemmatizer (dataset.py:1206, 2678).  Handles the regular -ing /
    -s / -ed inflections plus a small irregular table; asset action
    descriptions are near-universally base verbs already, so this only needs
    to be safe, not exhaustive."""
    v = verb.strip().lower()
    if not v or " " in v:  # multi-word phrases pass through untouched
        return v
    if v in _IRREGULAR_VERB_BASE:
        return _IRREGULAR_VERB_BASE[v]
    if v in _ALL_ACTION_WORDS:  # already a base verb
        return v
    if v.endswith("ying") and len(v) > 5:
        return v[:-4] + "ie"  # tying -> tie
    if v.endswith("ing") and len(v) > 4:
        stem = v[:-3]
        doubled = len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] in _CONSONANTS
        # prefer a candidate from the known action vocabulary
        for cand in (stem, stem[:-1] if doubled else None, stem + "e"):
            if cand and cand in _ALL_ACTION_WORDS:
                return cand
        if doubled and stem[-1] not in "lsz":  # hopping -> hop, but rolling -> roll
            return stem[:-1]
        return stem
    if v.endswith("ies") and len(v) > 4:
        return v[:-3] + "y"
    if v.endswith("es") and v[:-2].endswith(("sh", "ch", "ss", "x", "z", "o")):
        return v[:-2]
    if v.endswith("s") and not v.endswith("ss"):
        return v[:-1]
    return v


# ---------------------------------------------------------------------------
# camera-type classification (dataset.py:833-878 get_cam_type_v2)
# ---------------------------------------------------------------------------


def get_cam_type(
    obj_xyz, obj_rot, cam_xyz,
    front_degree_limit: float = 30.0,
    left_degree_limit: float = 30.0,
    height_degree_limit: float = 30.0,
) -> str:
    """Classify the camera as front/back x left/right x top/down relative to
    the object's orientation (30-degree bands map to empty strings)."""
    obj_rot = np.asarray(obj_rot, dtype=np.float64)
    to_cam = np.asarray(cam_xyz, dtype=np.float64) - np.asarray(obj_xyz, dtype=np.float64)
    y_axis = obj_rot[:, 1]
    z_axis = obj_rot[:, 2]
    unit = to_cam / (np.linalg.norm(to_cam) + 1e-6)

    def degree(a, b):
        return math.degrees(math.acos(np.clip(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12), -1, 1)))

    deg = degree(y_axis, unit)
    front = "" if abs(90 - deg) < front_degree_limit else ("front" if deg < 90 else "back")
    if abs(deg) < left_degree_limit or abs(180 - deg) < left_degree_limit:
        left = ""
    else:
        left = "left" if np.dot(np.cross(y_axis, to_cam), z_axis) < 0 else "right"
    z_deg = degree(z_axis, unit)
    top = "" if abs(90 - z_deg) < height_degree_limit else ("top" if z_deg < 90 else "down")
    return "_".join([front, left, top])


def camera_pose_descriptions(annotation_data: dict, seen_obj_idx_list, time_idx: int) -> list[str]:
    """Per-visible-object camera type at a frame (dataset.py:752-769)."""
    cam_entry = annotation_data["camera"][time_idx]
    cam_xyz = cam_entry[:3]
    out = []
    for idx in seen_obj_idx_list:
        obj_entry = annotation_data["objects"][str(idx)][time_idx]
        obj_xyz, obj_euler = obj_entry[-3:], obj_entry[3:6]
        from synfmc_tpu_torch.geometry.euler import euler_to_matrix_v2

        obj_rot = euler_to_matrix_v2(obj_euler[2], obj_euler[1], obj_euler[0])
        out.append(get_cam_type(obj_xyz, obj_rot, cam_xyz))
    return out


# ---------------------------------------------------------------------------
# metadata-driven descriptions
# ---------------------------------------------------------------------------


def get_background_description(hdri_json: dict, cam_row: dict, rng: random.Random) -> str:
    """HDRI description with scene-type fallback (dataset.py:25-42)."""
    comment = csv_param_to_dict(cam_row["Comment"])
    scene_type = comment["scene_type"]
    descriptions = hdri_json.get(comment["hdri"], {}).get("descriptions", [])
    description = rng.choice(descriptions) if descriptions else ""
    if description == "":
        description = scene_type.replace("near_ground", "near ground")
    return description


def get_seen_objects(
    mask_root: str,
    asset_json: dict,
    seq_meta: dict,
    time_idx: int,
    appearance_percentage: float = 0.0015,
    max_num: Optional[int] = None,
):
    """Visible-object detection + per-object descriptions at one frame
    (dataset.py:248-381).

    Reads ``total.png`` and per-object ``{i}.png`` masks under
    ``mask_root`` (already frame-specific), applies the bbox-area visibility
    filter, and pulls object/action descriptions from the asset JSON by
    animation segment.

    Returns (seen_obj_ids, seen_obj_idxs, total_mask, obj_masks,
    obj_descriptions, action_descriptions, action_types).
    """
    import os

    from synfmc_tpu_torch.data.image import imread

    objs_seq = seq_meta["objects"]
    obj_num = len(objs_seq)
    obj_ids = [csv_param_to_dict(objs_seq[str(i)]["Comment"])["obj_id"] for i in range(obj_num)]

    total_mask = imread(os.path.join(mask_root, "total.png"))
    total_mask = (total_mask > 0).astype(bool)
    if total_mask.ndim == 3:
        total_mask = total_mask.any(axis=-1)
    total_mask = total_mask[..., None]

    seen_ids, seen_idxs, obj_masks = [], [], []
    if obj_num == 1:
        if is_normal_size(total_mask, percentage=appearance_percentage):
            obj_masks.append(total_mask)
            seen_ids.append(obj_ids[0])
            seen_idxs.append(0)
    else:
        for i in range(obj_num):
            m = imread(os.path.join(mask_root, f"{i}.png"))
            m = (m > 0).astype(bool)
            if m.ndim == 3:
                m = m.any(axis=-1)
            m = total_mask * m[..., None]
            if is_normal_size(m, percentage=appearance_percentage):
                if max_num is not None and len(seen_ids) >= max_num:
                    break
                seen_ids.append(obj_ids[i])
                seen_idxs.append(i)
                obj_masks.append(m)

    obj_descriptions, action_descriptions, action_types = [], [], []
    for obj_id in seen_ids:
        idx = obj_ids.index(obj_id)
        row = objs_seq[str(idx)]
        time_ranges = eval(row["Time_Range_List"])  # noqa: S307 — trusted dataset metadata
        seg = next(
            (k for k, (s, e) in enumerate(time_ranges) if s <= time_idx <= e), None
        )
        assert seg is not None, f"frame {time_idx} outside object time ranges {time_ranges}"
        comment = csv_param_to_dict(row["Comment"])
        animation = eval(comment["animation_name_list"])[seg]  # noqa: S307
        action_type = eval(comment["action_type_list"])[seg]  # noqa: S307
        obj_descriptions.append(asset_json[obj_id]["description"])
        action_descriptions.append(asset_json[obj_id]["animation"][animation].get("description", ""))
        action_types.append(action_type)
    return seen_ids, seen_idxs, total_mask, obj_masks, obj_descriptions, action_descriptions, action_types


# ---------------------------------------------------------------------------
# action vocabulary per (scene_type, action_type)
# (family sizes mirror the reference word lists, dataset.py:981-1104)
# ---------------------------------------------------------------------------

ACTION_WORDS = {
    ("ground", "move"): ["move", "walk", "stroll", "jog", "run", "dash", "hurry", "advance"],
    ("ground", "jump"): ["jump", "leap"],
    ("ground", "idle"): ["idle", "rest", "stay", "remain", "halt", "wait"],
    ("near_ground", "near_ground_fly"): ["move", "shift", "drift", "fly", "glide", "skim"],
    ("near_ground", "idle"): ["idle", "rest", "stay", "remain", "pause", "halt", "float", "hover", "linger"],
    ("sky", "fly"): ["move", "shift", "fly", "soar", "glide"],
    ("sky", "idle"): ["idle", "rest", "stay", "remain", "pause", "halt", "float", "hover", "linger"],
    ("overwater", "move"): ["move", "shift", "drift", "glide", "swim", "cruise"],
    ("overwater", "idle"): ["idle", "rest", "stay", "remain", "pause", "halt", "float", "bob"],
    ("underwater", "swim"): ["move", "shift", "drift", "swim", "dive", "paddle"],
    ("underwater", "idle"): ["idle", "rest", "stay", "remain", "pause", "halt", "float", "drift"],
}

_ALL_ACTION_WORDS = {w for ws in ACTION_WORDS.values() for w in ws}


def action_phrase(scene_type: str, action_type: str, action_description: str, rng: random.Random) -> str:
    """Action wording: asset-provided description, else scene/action word list
    (get_action_description, dataset.py:1210-1268)."""
    if action_description:
        return action_description
    words = ACTION_WORDS.get((scene_type, action_type))
    if words is None:
        raise NotImplementedError(f"no action words for {(scene_type, action_type)}")
    return rng.choice(words)


# ---------------------------------------------------------------------------
# template families (sizes match dataset.py:1107-1204 & 2217-2270)
# ---------------------------------------------------------------------------

A_THE_LIST = ["a", "the"]

# noun-phrase object sentences (adjective-style: no finite verb)
ADJ_OBJ_TEMPLATE = [
    "{a_the} {object_name} that is {action_name_ing}",
    "{a_the} {action_name_ing} {object_name}",
    "{a_the} {object_name}",
]

# clause object sentences (finite verb)
NO_ADJ_OBJ_TEMPLATE = [
    "{a_the} {object_name} {action_name}",
    "{a_the} {object_name} is {action_name_ing}",
]

ADJ_CAM_TEMPLATE = [  # no present tense (pairs with noun-phrase objects)
    "{object_sentence} is shown from the {view_point_sentence} side",
    "{object_sentence} is recorded from a {view_point_sentence} angle",
    "the camera films {object_sentence} from the {view_point_sentence} direction",
    "{object_sentence} appears from the {view_point_sentence} viewpoint",
    "{object_sentence} is framed at a {view_point_sentence} angle",
    "{object_sentence} is pictured from the {view_point_sentence} side",
]

NO_ADJ_CAM_TEMPLATE = [
    "from the {view_point_sentence} side, {object_sentence}",
    "filmed from a {view_point_sentence} angle, {object_sentence}",
    "shot from the {view_point_sentence} direction, {object_sentence}",
]

BACK_ASSEMBLE_SINGLE_TEMPLATE = [
    "in {background}, {first_sentence}",
    "surrounded by {background}, {first_sentence}",
    "amid {background}, {first_sentence}",
    "with {background} around, {first_sentence}",
    "set against {background}, {first_sentence}",
    "with {background} as the backdrop, {first_sentence}",
    "{first_sentence} in {background}",
    "{first_sentence} surrounded by {background}",
    "{first_sentence} amid {background}",
    "{first_sentence} set against {background}",
    "{first_sentence} with {background} all around",
    "{first_sentence} with {background} as the backdrop",
]

NO_BACK_ASSEMBLE_SINGLE_TEMPLATE = [
    "{first_sentence}",
]

NO_BACK_ASSEMBLE_MULTI_TEMPLATE = [
    "{first_sentence} {concat} {second_sentence}",
]

# bare connectives between same-frame object sentences (dataset.py:1110)
CONCAT_LIST = ["and", ", and", "."]

# connectives between object noun-phrases inside one enter/exit event
OBJ_CONCAT_LIST = [
    "{sentence_1} and {sentence_2}",
    "{sentence_1} plus {sentence_2}",
    "{sentence_1} alongside {sentence_2}",
    "{sentence_1} accompanied by {sentence_2}",
]

ENTER_TEMPLATE = [
    "{objects} come into the frame",
    "{objects} enter the view",
    "{objects} appear in the scene",
    "{objects} move into the picture",
    "{objects} become visible",
    "{objects} arrive on screen",
    "{objects} step into view",
    "the frame now shows {objects}",
    "{objects} turn up in the shot",
]

EXIT_TEMPLATE = [
    "{objects} leave the view",
    "{objects} move out of the frame",
    "{objects} slip out of sight",
    "{objects} exit the scene",
    "{objects} drop out of view",
    "{objects} pass beyond the frame",
    "{objects} are gone from the screen",
    "{objects} fade from view",
    "{objects} head off-screen",
    "{objects} can no longer be seen",
]

THEN_TEMPLATE = [
    "{sentence_1}. then, {sentence_2}",
    "{sentence_1}. soon after, {sentence_2}",
    "{sentence_1}. following that, {sentence_2}",
    "{sentence_1}. a moment later, {sentence_2}",
    "{sentence_1}. next, {sentence_2}",
    "{sentence_1}. shortly afterwards, {sentence_2}",
    "{sentence_1}. after a while, {sentence_2}",
]

ENTER_EXIT_CONCAT_LIST = [
    ". at the same moment,",
    ", and",
    ", while",
    ", just as",
    ". simultaneously,",
    ". meanwhile,",
    ". in parallel,",
    ". around the same time,",
]

# ADOPTED VERBATIM from the reference (fmc/data/dataset.py:1187-1204):
# these strings are dataset-schema constants — they define the synthetic-
# descriptor distribution the released FMC checkpoints were trained on, so
# caption-space parity (and therefore weight-level parity) requires the
# exact text.  Everything else in this file is rephrased; this one family
# is deliberately not.
DESCRIPTOR_TEMPLATE = [
    "rendered video. {sentence}",
    "synthetic video. {sentence}",
    "this video is rendered using Game Engine. {sentence}",
    "the video is synthetic. {sentence}",
    "this is a synthetic video created with Game Engine. {sentence}",
    "note: this video is synthetically rendered using Game Engine. {sentence}",
    "{sentence}. note: this video is synthetically rendered using Game Engine",
    "generated using Game Engine. {sentence}",
    "{sentence}. generated using Game Engine",
    "it is rendered video and is not a real photograph. {sentence}",
    "the content of this video is rendered. {sentence}",
    "{sentence}. the content of this video is rendered",
    "this video is a virtual render produced. {sentence}",
    "{sentence}. this video is a virtual render produced",
]

# The reference's image (LoRA) dataset reuses the same "video" descriptor
# list verbatim (dataset.py:2138-2141); replicate that quirk.
IMAGE_DESCRIPTOR_TEMPLATE = DESCRIPTOR_TEMPLATE


# ---------------------------------------------------------------------------
# per-object sentence synthesis (get_seen_objs_description, dataset.py:2571)
# ---------------------------------------------------------------------------


def _strip_leading_article(desc: str) -> str:
    for word in ("a ", "the "):
        if desc.startswith(word):
            return desc[len(word):]
    return desc


def get_seen_objs_description(
    scene_type: str,
    object_description_list: list[str],
    action_description_list: list[str],
    action_type_list: list[str],
    camera_pose_description_list: list[str],
    rng: random.Random,
) -> tuple[list[str], list[str], list[str], list[str]]:
    """Build per-object sentences in four flavors:
    (no_adj, adj, chosen-coin, with-camera), mirroring reference
    get_seen_objs_description (dataset.py:2571-2670).

    - use_adj coin picks noun-phrase vs clause templates for the "chosen"
      sentence and the matching camera-template family;
    - a/the coin; verb lemmatized then conjugated (-s / -ing);
    - the camera sentence embeds a random non-empty subset of the
      front/left/top view words (random.sample of size randint(1, n)).
    """
    obj_num = len(object_description_list)
    assert len(action_description_list) == obj_num
    assert len(camera_pose_description_list) == obj_num and len(action_type_list) == obj_num

    no_adj_list, adj_list, chosen_list, cam_list = [], [], [], []
    for obj_desc, act_desc, act_type, cam_type in zip(
        object_description_list, action_description_list, action_type_list,
        camera_pose_description_list,
    ):
        obj_desc = _strip_leading_article(obj_desc.lower())
        act_desc = act_desc.lower()
        if not act_desc:
            act_desc = action_phrase(scene_type, act_type.lower(), "", rng)
        assert act_desc != ""

        use_adj = rng.choice([True, False])
        obj_tmpl = rng.choice(ADJ_OBJ_TEMPLATE if use_adj else NO_ADJ_OBJ_TEMPLATE)
        cam_tmpl = rng.choice(ADJ_CAM_TEMPLATE if use_adj else NO_ADJ_CAM_TEMPLATE)
        adj_tmpl = rng.choice(ADJ_OBJ_TEMPLATE)
        no_adj_tmpl = rng.choice(NO_ADJ_OBJ_TEMPLATE)
        a_the = rng.choice(A_THE_LIST)

        base = lemmatize_verb(act_desc)
        fields = dict(
            a_the=a_the,
            object_name=obj_desc,
            action_name=third_person_singular(base),
            action_name_ing=present_continuous(base),
        )
        chosen = obj_tmpl.format(**fields)
        adj = adj_tmpl.format(**fields)
        no_adj = no_adj_tmpl.format(**fields)

        view_words = [s for s in cam_type.split("_") if s]
        if view_words:
            k = rng.randint(1, len(view_words))
            view = " ".join(rng.sample(view_words, k))
            cam = cam_tmpl.format(object_sentence=chosen, view_point_sentence=view)
        else:
            cam = chosen  # camera inside every dead band: no view phrase
        # whitespace squeeze (dataset.py:2655-2661)
        squeeze = lambda s: " ".join(w for w in s.split(" ") if w)
        no_adj_list.append(squeeze(no_adj))
        adj_list.append(squeeze(adj))
        chosen_list.append(squeeze(chosen))
        cam_list.append(squeeze(cam))
    return no_adj_list, adj_list, chosen_list, cam_list


def get_enter_exit(prev_idxs: list, cur_idxs: list) -> tuple[list, list]:
    """(dataset.py:5157-5164)"""
    enter = [i for i in cur_idxs if i not in prev_idxs]
    exit_ = [i for i in prev_idxs if i not in cur_idxs]
    return enter, exit_


# ---------------------------------------------------------------------------
# caption assembly
# ---------------------------------------------------------------------------


def _first_frame_description(
    background: str,
    obj_sentences: list[str],
    cam_sentences: list[str],
    rng: random.Random,
    use_cam_sentence: bool = False,
) -> str:
    """The first-keyframe (or single-image) assembly: background coin +
    per-object concat (dataset.py:4938-5000).

    Camera sentences are built but disabled in every reference training
    path: the video assembly draws ``no_cam_des = choice([True, True])``
    (dataset.py:4944 etc.) and the image assembly hard-codes
    ``no_cam_des = True`` (1521) — so ``use_cam_sentence`` defaults False;
    True restores the per-sentence coin of the dormant with-cam variant
    (assemble_description, 1272-1429).
    """

    def pick(i):
        if use_cam_sentence and not rng.choice([True, False]):
            return cam_sentences[i]
        return obj_sentences[i]

    use_back = rng.choice([True, False])
    first = pick(0)
    if use_back:
        description = rng.choice(BACK_ASSEMBLE_SINGLE_TEMPLATE).format(
            background=background, first_sentence=first
        )
    else:
        description = rng.choice(NO_BACK_ASSEMBLE_SINGLE_TEMPLATE).format(first_sentence=first)
    for i in range(1, len(obj_sentences)):
        description = rng.choice(NO_BACK_ASSEMBLE_MULTI_TEMPLATE).format(
            first_sentence=description,
            concat=rng.choice(CONCAT_LIST),
            second_sentence=pick(i),
        )
    return description


def _concat_object_phrases(phrases: list[str], rng: random.Random) -> str:
    out = phrases[0]
    for p in phrases[1:]:
        out = rng.choice(OBJ_CONCAT_LIST).format(sentence_1=out, sentence_2=p)
    return out


def apply_descriptor(sentence: str, rng: random.Random,
                     prob: float = 0.9, is_video: bool = True) -> str:
    """90% synthetic-descriptor wrap (dataset.py:5134-5151)."""
    if sentence and rng.random() < prob:
        family = DESCRIPTOR_TEMPLATE if is_video else IMAGE_DESCRIPTOR_TEMPLATE
        return rng.choice(family).format(sentence=sentence)
    return sentence


def assemble_video_caption(
    scene_type: str,
    background: str,
    keyframes: list[dict],
    is_multi: bool,
    rng: random.Random,
    use_descriptor_prob: float = 0.9,
    is_track_single: Optional[bool] = None,
) -> tuple[str, str]:
    """Full temporal caption for a sampled clip (dataset.py:4896-5155).

    ``keyframes``: one dict per chosen key frame with keys
    {seen_idxs, obj_descs, act_descs, act_types, cam_types}.

    Two regimes, as in the reference:
    - multi-object sequences not tracking a single object: keyframe 0 gets
      the full scene description; later keyframes narrate enter/exit events
      (adj noun-phrases + OBJ_CONCAT + ENTER/EXIT templates, flipped-order
      ENTER_EXIT_CONCAT when both occur); the per-keyframe descriptions are
      THEN-chained.
    - otherwise (single tracked object): describe keyframe 0, then THEN-
      narrate each *action-type change* with a clause sentence.  (The
      reference also records camera-type changes but never narrates them —
      dead code we do not replicate.)

    Returns (caption, background_caption); both receive an independent 90%
    descriptor wrap as in the reference (5134-5151).
    """
    per_key = []
    for kf in keyframes:
        per_key.append(
            get_seen_objs_description(
                scene_type, kf["obj_descs"], kf["act_descs"], kf["act_types"],
                kf["cam_types"], rng,
            )
        )  # (no_adj, adj, chosen, cam) lists

    if is_track_single is None:
        # callers with full-clip visibility pass this in (the reference
        # checks every frame, dataset.py:4906-4916); fall back to keyframes
        is_track_single = True
        prev_id = None
        for kf in keyframes:
            ids = kf.get("seen_ids", kf["seen_idxs"])
            if len(ids) != 1 or (prev_id is not None and ids[0] != prev_id):
                is_track_single = False
                break
            prev_id = ids[0]

    if is_multi and not is_track_single:
        adj_by_idx: dict = {}
        descriptions = []
        prev_idxs: list = []
        for kf, (no_adj, adj, chosen, cam) in zip(keyframes, per_key):
            for i, obj_idx in enumerate(kf["seen_idxs"]):
                adj_by_idx.setdefault(obj_idx, adj[i])
            if not prev_idxs:
                description = _first_frame_description(background, chosen, cam, rng)
            else:
                enter, exit_ = get_enter_exit(prev_idxs, kf["seen_idxs"])
                enter_desc = exit_desc = ""
                if enter:
                    enter_desc = rng.choice(ENTER_TEMPLATE).format(
                        objects=_concat_object_phrases([adj_by_idx[i] for i in enter], rng)
                    )
                if exit_:
                    exit_desc = rng.choice(EXIT_TEMPLATE).format(
                        objects=_concat_object_phrases([adj_by_idx[i] for i in exit_], rng)
                    )
                if enter_desc and exit_desc:
                    a, b = (exit_desc, enter_desc) if rng.choice([True, False]) else (enter_desc, exit_desc)
                    description = f"{a} {rng.choice(ENTER_EXIT_CONCAT_LIST)} {b}"
                else:
                    description = enter_desc or exit_desc
            prev_idxs = kf["seen_idxs"]
            if description:
                descriptions.append(description)
        total = descriptions[0]
        for d in descriptions[1:]:
            total = rng.choice(THEN_TEMPLATE).format(sentence_1=total, sentence_2=d)
    else:
        # single tracked object: narrate action-type changes across keyframes
        change_key_idxs = []
        prev_action = None
        for t, kf in enumerate(keyframes):
            action = kf["act_types"][0] if kf["act_types"] else None
            if prev_action is not None and action != prev_action:
                change_key_idxs.append(t)
            prev_action = action
        total = _first_frame_description(background, per_key[0][2], per_key[0][3], rng)
        for t in change_key_idxs:
            no_adj = per_key[t][0][0]
            total = rng.choice(THEN_TEMPLATE).format(sentence_1=total, sentence_2=no_adj)

    caption = apply_descriptor(total, rng, prob=use_descriptor_prob, is_video=True)
    background_caption = apply_descriptor(
        background, rng, prob=use_descriptor_prob, is_video=True
    )
    return caption, background_caption


def assemble_scene_description(
    scene_type: str,
    background: str,
    obj_descs: list[str],
    act_descs: list[str],
    act_types: list[str],
    cam_types: list[str],
    rng: random.Random,
    use_cam_sentence: bool = False,
) -> str:
    """One-moment scene description: per-object sentences + background coin
    (assemble_description / assemble_description_without_cam,
    dataset.py:1272-1578).  No descriptor wrap — callers apply it."""
    _, _, chosen, cam = get_seen_objs_description(
        scene_type, obj_descs, act_descs, act_types, cam_types, rng
    )
    return _first_frame_description(
        background.lower(), chosen, cam, rng, use_cam_sentence=use_cam_sentence
    )


def assemble_image_caption(
    scene_type: str,
    background: str,
    obj_descs: list[str],
    act_descs: list[str],
    act_types: list[str],
    cam_types: list[str],
    rng: random.Random,
    use_descriptor_prob: float = 0.9,
) -> str:
    """Single-frame caption for the stage-1 image dataset
    (assemble_description_without_cam + descriptor wrap,
    dataset.py:1431-1578 & 2128-2142)."""
    description = assemble_scene_description(
        scene_type, background, obj_descs, act_descs, act_types, cam_types, rng
    )
    return apply_descriptor(description, rng, prob=use_descriptor_prob, is_video=False)
