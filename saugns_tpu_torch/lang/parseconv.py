"""Parse result to Program converter.

Port of sau/parser/parseconv.h: voice allocation with expiry-based
reuse, operator allocation, modulator-list concat-on-append semantics,
voice-graph construction (post-order carrier->modulator traversal with
nesting levels), and final Program assembly.
"""
from __future__ import annotations

import sys

from . import script as S
from . import program as P


class VoAllocState:
    """sauVoAllocState (parseconv.h:55-60)."""
    __slots__ = ('obj_id', 'duration_ms', 'carr_op_id', 'flags')

    def __init__(self):
        self.obj_id = 0
        self.duration_ms = 0
        self.carr_op_id = 0
        self.flags = 0


VAS_HAS_CARR = 1 << 0
VAS_SET_GRAPH = 1 << 1

OAS_VISITED = 1 << 0


class OpAllocState:
    """sauOpAllocState (parseconv.h:137-140)."""
    __slots__ = ('mods', 'flags')

    def __init__(self):
        # per-use-type modulator id list (use types 1..8 -> index 0..7)
        self.mods = [()] * (P.POP_NAMED - 1)
        self.flags = 0


class ParseConv:
    """Accumulates output events during parsing (parseconv.h:215-224)."""

    def __init__(self):
        self.ev_arr = []       # list[P.Event]
        self.oa = []           # list[OpAllocState]
        self.va = []           # list[VoAllocState]
        self.ev = None         # current P.Event
        self.ev_op_data = []   # op data being gathered for current event
        self.tot_dur_ms = 0
        self.op_nest_level = 0
        self.op_nest_max = 0
        self.vo_graph = []     # reusable list[P.OpRef]

    # -- duration accounting ------------------------------------------------

    def sum_dur_ms(self, add_ms):
        self.tot_dur_ms += add_ms

    def end_dur_ms(self):
        """parseconv.h:233-242."""
        remaining_ms = 0
        for vas in self.va:
            if vas.duration_ms > remaining_ms:
                remaining_ms = vas.duration_ms
        self.sum_dur_ms(remaining_ms)
        return self.tot_dur_ms

    # -- voice allocation (parseconv.h:72-125) -------------------------------

    def voalloc_update(self, objects, e):
        for vas in self.va:
            if vas.duration_ms < e.wait_ms:
                vas.duration_ms = 0
            else:
                vas.duration_ms -= e.wait_ms
        obj = e.main_obj
        obj_id = obj.ref.obj_id
        info = objects[obj_id]
        vas = None
        vo_id = None
        if obj.prev_ref is not None:
            obj_id = info.root_op_obj
            info = objects[obj_id]
            if info.last_vo_id != P.PVO_NO_ID:
                vo_id = info.last_vo_id
                vas = self.va[vo_id]
                # PRESERVED
                if e.ev_flags & S.SDEV_VOICE_SET_DUR:
                    vas.duration_ms = e.dur_ms
                obj.ref.vo_id = vo_id
                return vas
        e.ev_flags |= S.SDEV_ASSIGN_VOICE
        for vid, cand in enumerate(self.va):
            if cand.duration_ms == 0:
                old_info = objects[cand.obj_id]
                old_info.last_vo_id = P.PVO_NO_ID
                vas = self.va[vid] = VoAllocState()
                vo_id = vid
                break
        else:
            vo_id = len(self.va)
            vas = VoAllocState()
            self.va.append(vas)
        info.last_vo_id = vo_id
        vas.obj_id = obj_id
        if e.ev_flags & S.SDEV_VOICE_SET_DUR:
            vas.duration_ms = e.dur_ms
        obj.ref.vo_id = vo_id
        return vas

    # -- operator allocation (parseconv.h:155-171) ---------------------------

    def opalloc_update(self, objects, od):
        info = objects[od.ref.obj_id]
        if od.prev_ref is None:
            op_id = len(self.oa)
            self.oa.append(OpAllocState())
            info.last_op_id = op_id
        return info

    # -- list conversion ------------------------------------------------------

    @staticmethod
    def _count_list(list_in):
        count = 0
        item = list_in.first_item
        while item is not None:
            if item.ref.obj_type == P.POBJT_OP:
                count += 1
            item = item.ref.next
        return count

    def convert_list(self, objects, list_in):
        """parseconv.h:254-273; returns tuple of op ids."""
        ids = []
        item = list_in.first_item
        while item is not None:
            if item.ref.obj_type == P.POBJT_OP:
                ids.append(objects[item.ref.obj_id].last_op_id)
            item = item.ref.next
        return tuple(ids)

    # -- op data conversion (parseconv.h:281-331) ------------------------------

    def convert_opdata(self, objects, op, use_type, info):
        op_id = info.last_op_id
        oas = self.oa[op_id]
        ood = P.OpData()
        ood.id = op_id
        ood.params = op.params
        ood.time = P.Time(op.time.v_ms, op.time.flags)
        ood.pan = op.pan
        ood.amp = op.amp
        ood.amp2 = op.amp2
        ood.freq = op.freq
        ood.freq2 = op.freq2
        ood.pm_a = op.pm_a
        ood.phase = op.phase
        ood.use_type = use_type
        ood.type = info.op_type
        ood.seed = op.seed
        ood.mode_main = op.mode_main
        ood.mode_ras = op.mode_ras.copy()
        self.ev_op_data.append(ood)
        vas = self.va[self.ev.vo_id]
        for in_list in op.mods:
            t = in_list.use_type - 1
            arr = self.convert_list(objects, in_list)
            if in_list.append:
                if not arr:
                    continue  # omit no-op
                arr = oas.mods[t] + arr
            else:
                if not arr and not oas.mods[t]:
                    continue  # omit no-op (C: pointer-equal blank arrays)
            oas.mods[t] = arr
            vas.flags |= VAS_SET_GRAPH
            setattr(ood, P.OpData.MOD_FIELDS[t], arr)
        return True

    def convert_ops(self, objects, op_list, link):
        """parseconv.h:340-363."""
        if op_list is None:
            return True
        op = op_list.first_item
        while op is not None:
            if op.ref.obj_type != P.POBJT_OP:
                op = op.ref.next
                continue
            if op.op_flags & S.SDOP_MULTIPLE:
                op = op.ref.next
                continue
            info = self.opalloc_update(objects, op)
            for in_list in op.mods:
                self.convert_ops(objects, in_list, link)
            if link:
                self.convert_opdata(objects, op, op_list.use_type, info)
            op = op.ref.next
        return True

    # -- voice graph (parseconv.h:368-462) --------------------------------------

    def _graph_handle_op_list(self, op_list, mod_use):
        for op_id in op_list:
            self._graph_handle_op_node(P.OpRef(op_id, mod_use,
                                               self.op_nest_level))

    def _graph_handle_op_node(self, op_ref):
        if op_ref.id >= len(self.oa):
            # invalid graph from degenerate input; reference crashes here
            return
        oas = self.oa[op_ref.id]
        if oas.flags & OAS_VISITED:
            print("warning: voicegraph: skipping operator %u; "
                  "circular references unsupported" % op_ref.id,
                  file=sys.stderr)
            return
        if self.op_nest_level > self.op_nest_max:
            self.op_nest_max = self.op_nest_level
        self.op_nest_level += 1
        oas.flags |= OAS_VISITED
        for i in range(1, P.POP_NAMED):
            self._graph_handle_op_list(oas.mods[i - 1], i)
        oas.flags &= ~OAS_VISITED
        self.op_nest_level -= 1
        self.vo_graph.append(op_ref)

    def voicegraph_set(self, ev):
        vas = self.va[ev.vo_id]
        if vas.flags & VAS_HAS_CARR:
            self._graph_handle_op_node(P.OpRef(vas.carr_op_id,
                                               P.POP_N_carr, 0))
            ev.op_list = list(self.vo_graph)
        self.vo_graph.clear()

    # -- event conversion (parseconv.h:472-517) -----------------------------------

    def convert_event(self, objects, e):
        obj = e.main_obj
        if obj is None:
            # The reference crashes here (devtests/crashes/*); we skip.
            return True
        if obj.ref.obj_type == P.POBJT_LIST:
            self.convert_ops(objects, obj, False)
            return True
        if obj.ref.obj_type != P.POBJT_OP:
            return True
        vas = self.va[obj.ref.vo_id]
        vas.flags &= ~VAS_SET_GRAPH
        out_ev = P.Event()
        out_ev.wait_ms = e.wait_ms
        out_ev.vo_id = obj.ref.vo_id
        self.ev_arr.append(out_ev)
        self.ev = out_ev
        e_objs = S.ListData()
        e_objs.first_item = obj
        self.convert_ops(objects, e_objs, True)
        if self.ev_op_data:
            out_ev.op_data = list(self.ev_op_data)
            self.ev_op_data.clear()
        if e.ev_flags & S.SDEV_ASSIGN_VOICE:
            info = objects[obj.ref.obj_id]
            info = objects[info.root_op_obj]
            vas.flags |= VAS_HAS_CARR | VAS_SET_GRAPH
            vas.carr_op_id = info.last_op_id
        out_ev.carr_op_id = vas.carr_op_id
        if vas.flags & VAS_SET_GRAPH:
            self.voicegraph_set(out_ev)
        return True

    # -- finalization (parseconv.h:524-571) ------------------------------------------

    def check_validity(self, name):
        error = False
        if name is None:
            name = '(null)'
        if len(self.va) > P.PVO_MAX_ID:
            print("%s: error: number of voices used cannot exceed %d"
                  % (name, P.PVO_MAX_ID), file=sys.stderr)
            error = True
        if len(self.oa) > P.POP_MAX_ID:
            print("%s: error: number of operators used cannot exceed %d"
                  % (name, P.POP_MAX_ID), file=sys.stderr)
            error = True
        return not error

    def create_program(self, name, sopt):
        prg = P.Program()
        prg.events = self.ev_arr
        prg.ampmult = sopt.ampmult
        if not (sopt.set & S.SOPT_AMPMULT):
            prg.mode |= P.PMODE_AMP_DIV_VOICES
        prg.vo_count = len(self.va)
        prg.op_count = len(self.oa)
        prg.op_nest_depth = self.op_nest_max
        prg.duration_ms = self.tot_dur_ms
        prg.name = name
        prg.sopt = sopt
        return prg
