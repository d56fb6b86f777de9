"""Kinematic graph: the offline (NumPy) topology/indexing layer.

Counterpart of ``jaxsim_tpu/parsers/kinematic_graph.py``:

* BFS link indexing (root = 0), joint index = child link index, frames
  indexed after links;
* graph construction that drops unconnected elements;
* ``reduce(considered_joints)``: lump removed links into their parents
  (leaf → root), re-pose affected joints, turn removed links into frames;
* offline forward kinematics at the initial joint positions
  (:class:`KinematicGraphTransforms`).

Everything here runs once at model-build time in plain Python/NumPy; nothing
is traced.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from collections.abc import Iterable, Sequence

import numpy as np
import numpy.typing as npt

from jaxsim_tpu_torch.math import np_spatial

from .descriptions.joint import JointDescription, JointType
from .descriptions.link import LinkDescription

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RootPose:
    """World pose of the kinematic-graph root (wxyz quaternion)."""

    root_position: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    root_quaternion: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0])
    )

    def to_matrix(self) -> npt.NDArray:
        return np_spatial.transform_from_quat_trans(
            self.root_quaternion, self.root_position
        )

    def __hash__(self) -> int:
        return hash(
            (tuple(self.root_position.tolist()), tuple(self.root_quaternion.tolist()))
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, RootPose) and hash(self) == hash(other)


@dataclasses.dataclass(eq=False)
class KinematicGraph(Sequence[LinkDescription]):
    """A connected acyclic graph of links (nodes) and joints (edges)."""

    root: LinkDescription
    joints: list[JointDescription] = dataclasses.field(default_factory=list)
    frames: list[LinkDescription] = dataclasses.field(default_factory=list)
    root_pose: RootPose = dataclasses.field(default_factory=RootPose)

    # Joints removed by graph construction/reduction (kept for bookkeeping).
    _joints_removed: list[JointDescription] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        # BFS link indexing: root gets 0.
        for index, link in enumerate(self):
            link.index = index

        link_names = [l.name for l in self]
        frame_names = [f.name for f in self.frames]
        joint_names = [j.name for j in self.joints]
        assert len(link_names) == len(set(link_names))
        assert len(frame_names) == len(set(frame_names))
        assert len(joint_names) == len(set(joint_names))
        assert set(link_names).isdisjoint(set(frame_names))

        # Frames: name-sorted, indexed after links.
        self.frames.sort(key=lambda f: f.name)
        for index, frame in enumerate(self.frames):
            frame.index = index + len(link_names)

        # Joint index = child link index (1-based).
        links_dict = {l.name: l for l in self}
        for joint in self.joints:
            joint.index = links_dict[joint.child.name].index
        assert len({j.index for j in self.joints}) == len(self.joints)
        self.joints.sort(key=lambda j: j.index)

    # ----- dict views -----

    @property
    def links_dict(self) -> dict[str, LinkDescription]:
        return {l.name: l for l in self}

    @property
    def frames_dict(self) -> dict[str, LinkDescription]:
        return {f.name: f for f in self.frames}

    @property
    def joints_dict(self) -> dict[str, JointDescription]:
        return {j.name: j for j in self.joints}

    @property
    def joints_connection_dict(self) -> dict[tuple[str, str], JointDescription]:
        return {(j.parent.name, j.child.name): j for j in self.joints}

    def link_names(self) -> list[str]:
        return [l.name for l in self]

    def joint_names(self) -> list[str]:
        return [j.name for j in self.joints]

    def frame_names(self) -> list[str]:
        return [f.name for f in self.frames]

    @property
    def joints_removed(self) -> list[JointDescription]:
        return self._joints_removed

    # ----- construction -----

    @staticmethod
    def build_from(
        links: list[LinkDescription],
        joints: list[JointDescription],
        frames: list[LinkDescription] | None = None,
        root_link_name: str | None = None,
        root_pose: RootPose = RootPose(),
    ) -> "KinematicGraph":
        if root_link_name is None:
            root_link_name = links[0].name
            _log.debug(f"Assuming '{root_link_name}' as the root link")

        (
            root_node,
            graph_joints,
            graph_frames,
            unconnected_links,
            unconnected_joints,
            unconnected_frames,
        ) = KinematicGraph._create_graph(
            links=links, joints=joints, root_link_name=root_link_name, frames=frames
        )

        for el in unconnected_links + unconnected_joints + unconnected_frames:
            _log.warning(f"Ignoring unconnected element: '{el.name}'")

        return KinematicGraph(
            root=root_node,
            joints=graph_joints,
            frames=graph_frames,
            root_pose=root_pose,
            _joints_removed=unconnected_joints,
        )

    @staticmethod
    def _create_graph(
        links: list[LinkDescription],
        joints: list[JointDescription],
        root_link_name: str,
        frames: list[LinkDescription] | None = None,
    ):
        links_dict = {l.name: l for l in links}
        frames = frames if frames is not None else []
        frames_dict = {f.name: f for f in frames}

        for frame in frames:
            assert frame.parent_name not in (None, "", "__model__"), frame
            assert frame.parent_name not in frames_dict, frame

        if root_link_name not in links_dict:
            raise ValueError(root_link_name)

        # Reset connectivity and re-derive it from the joints.
        for link in links_dict.values():
            link.children = tuple()

        for joint in joints:
            parent_link = links_dict[joint.parent.name]
            child_link = links_dict[joint.child.name]
            child_link.parent_name = parent_link.name
            if child_link.name not in {l.name for l in parent_link.children}:
                parent_link.children = (*parent_link.children, child_link)

        connected_links = list(
            KinematicGraph.breadth_first_search(root=links_dict[root_link_name])
        )
        connected_link_names = {l.name for l in connected_links}

        connected_joints = [
            j
            for j in joints
            if j.parent.name in connected_link_names
            and j.child.name in connected_link_names
        ]
        connected_joint_names = {j.name for j in connected_joints}

        connected_frames = [f for f in frames if f.parent_name in connected_link_names]
        connected_frame_names = {f.name for f in connected_frames}

        removed_joints = [j for j in joints if j.name not in connected_joint_names]
        unconnected_links = [l for l in links if l.name not in connected_link_names]
        for link in unconnected_links:
            link.children = tuple()
        unconnected_frames = [f for f in frames if f.name not in connected_frame_names]

        return (
            links_dict[root_link_name],
            connected_joints,
            connected_frames,
            unconnected_links,
            removed_joints,
            unconnected_frames,
        )

    @staticmethod
    def breadth_first_search(
        root: LinkDescription,
    ) -> Iterable[LinkDescription]:
        queue = [root]
        visited = {root.name}
        yield root
        while queue:
            node = queue.pop(0)
            for child in node.children:
                if child.name not in visited:
                    visited.add(child.name)
                    yield child
                    queue.append(child)

    # ----- reduction -----

    def reduce(self, considered_joints: Sequence[str]) -> "KinematicGraph":
        """Reduce the graph by removing every joint not in ``considered_joints``.

        Removed joints are locked at their ``initial_position``; their child
        links are lumped into the parents and become frames of the reduced
        graph (same observable behavior as reference
        ``kinematic_graph.py:379-611``; the merge bookkeeping here uses an
        explicit absorbed→survivor map instead of dict aliasing).
        """
        keep = set(considered_joints)
        unknown = keep - set(self.joint_names())
        if unknown:
            raise ValueError(f"Joints not part of the graph: {unknown}")

        locked = [name for name in self.joint_names() if name not in keep]
        if not locked:
            _log.info("Graph reduction requested with no joints to lock")
            return copy.deepcopy(self)

        # Working copies: ``pool`` maps each surviving link name to its
        # (possibly lumped) working object; ``absorbed_by`` records, for every
        # removed link, the name of the link that absorbed its inertia.
        pool = copy.deepcopy(self.links_dict)
        working_joints = copy.deepcopy(self.joints_dict)
        fk = KinematicGraphTransforms(graph=self)

        doomed = {working_joints[name].child.name for name in locked}

        def survivor_of(name: str) -> str:
            """Chase the merge chain to the link that now carries ``name``."""
            while name in absorbed_by:
                name = absorbed_by[name]
            return name

        absorbed_by: dict[str, str] = {}

        # Fold doomed links into their parents. Reversed-BFS order visits
        # children before parents, so a doomed link's own parent has not been
        # folded away yet when the link is processed — each merge target is
        # therefore resolved through ``survivor_of`` only for bookkeeping
        # consistency, never more than one hop deep at merge time.
        for node in reversed(list(self)):
            if node.name not in doomed:
                continue
            child = pool.pop(node.name)
            host_name = survivor_of(node.parent_name)
            host = pool[host_name]
            pool[host_name] = host.lump_with(
                link=child,
                lumped_H_removed=fk.relative_transform(
                    relative_to=host_name, name=child.name
                ),
            )
            absorbed_by[child.name] = host_name

        # Kept joints hanging off a removed link get re-attached to the link
        # that absorbed it, with the pose re-expressed in the new parent.
        for name in considered_joints:
            joint = working_joints[name]
            if joint.parent.name not in doomed:
                continue
            new_parent = pool[survivor_of(joint.parent.name)]
            joint.pose = fk.relative_transform(
                relative_to=new_parent.name, name=joint.name
            )
            joint.parent = new_parent

        # Rebuild connectivity from the kept joints only. Removed links are
        # fed back in as PRISTINE copies (their inertia already lives in the
        # lumped survivors) so _create_graph drops them as unconnected and
        # they re-enter the reduced graph as frames.
        rebuild_links = {
            name: copy.deepcopy(link)
            for name, link in self.links_dict.items()
            if name in doomed
        }
        rebuild_links.update(pool)

        (
            new_root,
            kept_joints,
            carried_frames,
            orphan_links,
            orphan_joints,
            _orphan_frames,
        ) = KinematicGraph._create_graph(
            links=list(rebuild_links.values()),
            joints=[working_joints[name] for name in considered_joints],
            root_link_name=self.root.name,
        )

        for orphan in orphan_links:
            _log.debug(f"Demoting lumped link '{orphan.name}' to a frame")

        reduced_graph = KinematicGraph(
            root=new_root,
            joints=kept_joints,
            frames=copy.deepcopy(self.frames) + orphan_links + carried_frames,
            root_pose=self.root_pose,
            _joints_removed=(
                self._joints_removed
                + orphan_joints
                + [working_joints[name] for name in locked]
            ),
        )

        # Re-express every frame on its surviving parent link. Poses come
        # from the FULL-graph FK (at the locked joint positions) so the
        # world-frame kinematics are unchanged by the reduction.
        fk_reduced = KinematicGraphTransforms(graph=reduced_graph)
        for frame in reduced_graph.frames:
            anchor = fk_reduced.find_parent_link_of_frame(name=frame.name)
            assert anchor in reduced_graph.links_dict, anchor
            frame.pose = fk.relative_transform(relative_to=anchor, name=frame.name)
            frame.parent_name = anchor
            frame.mass = 0.0
            frame.inertia = np.zeros((6, 6))

        return reduced_graph

    # ----- Sequence protocol (BFS order) -----

    def __iter__(self):
        yield from KinematicGraph.breadth_first_search(root=self.root)

    def __reversed__(self):
        yield from reversed(list(iter(self)))

    def __len__(self) -> int:
        return len(list(iter(self)))

    def __contains__(self, item: str | LinkDescription) -> bool:
        if isinstance(item, str):
            return item in self.link_names()
        if isinstance(item, LinkDescription):
            return item in set(iter(self))
        raise TypeError(type(item).__name__)

    def __getitem__(self, key: int | str) -> LinkDescription:
        if isinstance(key, str):
            if key not in self.link_names():
                raise KeyError(key)
            return self.links_dict[key]
        if isinstance(key, int):
            return list(iter(self))[key]
        raise TypeError(type(key).__name__)


@dataclasses.dataclass(frozen=True)
class KinematicGraphTransforms:
    """Offline FK over the graph at the (settable) initial joint positions
    (reference ``kinematic_graph.py:766-981``)."""

    graph: KinematicGraph

    _transform_cache: dict[str, npt.NDArray] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _initial_joint_positions: dict[str, float] = dataclasses.field(
        init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        object.__setattr__(
            self,
            "_initial_joint_positions",
            {j.name: j.initial_position for j in self.graph.joints},
        )

    def transform(self, name: str) -> npt.NDArray:
        """4×4 pose of a link/joint/frame w.r.t. the model root frame."""
        if name in self._transform_cache:
            return self._transform_cache[name]

        if name in self.graph.joints_dict:
            joint = self.graph.joints_dict[name]
            M_H_L = self.transform(name=joint.parent.name)
            L_H_pre = joint.pose
            pre_H_J = self.pre_H_suc(
                joint_type=joint.jtype,
                joint_axis=joint.axis,
                joint_position=self._initial_joint_positions[joint.name],
            )
            self._transform_cache[name] = M_H_L @ L_H_pre @ pre_H_J
            return self._transform_cache[name]

        if name in self.graph.links_dict:
            link = self.graph.links_dict[name]
            if link.name == self.graph.root.name:
                return np.asarray(link.pose)
            parent_joint = self.graph.joints_connection_dict[
                link.parent_name, link.name
            ]
            M_H_J = self.transform(name=parent_joint.name)
            self._transform_cache[name] = M_H_J @ np.asarray(link.pose)
            return self._transform_cache[name]

        if name not in self.graph.frames_dict:
            raise ValueError(name)

        frame = self.graph.frames_dict[name]
        M_H_L = self.transform(name=frame.parent_name)
        self._transform_cache[name] = M_H_L @ np.asarray(frame.pose)
        return self._transform_cache[name]

    def relative_transform(self, relative_to: str, name: str) -> npt.NDArray:
        M_H_target = self.transform(name=name)
        M_H_R = self.transform(name=relative_to)
        R, p = M_H_R[:3, :3], M_H_R[:3, 3]
        inv = np.eye(4)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ p
        return inv @ M_H_target

    @staticmethod
    def pre_H_suc(
        joint_type: int,
        joint_axis: npt.NDArray,
        joint_position: float | None = None,
    ) -> npt.NDArray:
        s = float(joint_position) if joint_position is not None else 0.0
        return np_spatial.joint_transform(joint_type, joint_axis, s)

    def find_parent_link_of_frame(self, name: str) -> str:
        try:
            frame = self.graph.frames_dict[name]
        except KeyError as e:
            raise ValueError(f"Frame '{name}' not in the kinematic graph") from e
        if frame.parent_name in self.graph.links_dict:
            return frame.parent_name
        if frame.parent_name in self.graph.frames_dict:
            return self.find_parent_link_of_frame(name=frame.parent_name)
        raise RuntimeError(
            f"Failed to find parent link of frame '{name}' (parent:"
            f" '{frame.parent_name}')"
        )


__all__ = [
    "KinematicGraph",
    "KinematicGraphTransforms",
    "RootPose",
    "JointType",
]
