'''
Blender RenderEngine integration.

Reference: ptina_tpu/blender.py (reference ptina/blender.py:283-948).
Registers a "PTINA_TPU_TORCH" render engine with final (F12) renders
exporting the Combined / Albedo / Normal passes, a progressively refined
viewport (a resolution ladder from 1 / start_pixel_size up, then
accumulated samples, blitted through the `gpu` module), depsgraph
diffing so edits re-upload only what changed, and a render properties
group and panel that reuse Cycles' panels.

The headless helpers are copied (parse_node_value,
principled_to_material, light_to_pool_entry, world_background,
classify_updates, ViewportRefiner, PRINCIPLED_SOCKETS, RENDER_PASSES)
and tested without Blender (tests/test_torch_blender.py).  Two more
headless helpers hold what the engine asks of the worker, so that a
caller without bpy can make the same calls: sync_worker (the scene
upload of the reference's _on_update) and viewport_pass (one rung of the
viewport ladder).  The engine class is built against the port's worker,
every call serialised onto one daemon thread through
utils.daemon.DaemonModule; the worker keeps its scene, film and kernels
on the card (worker.init's default).

Deliberate differences from the reference:
  * its own identity, so both add-ons install side by side: bl_idname
    'PTINA_TPU_TORCH', its own label, panel and scene property
    (`scene.ptina_torch_render`);
  * the viewport pass runs on a threading.Thread; the reference wraps it
    in utils.daemon.DaemonThread, which takes a name and has no start(),
    so its view_draw raises.  An exception on that thread is kept and
    raised by the next view_draw, so it is never swallowed.

bpy / gpu imports are deferred so this module imports anywhere.
'''

import threading

import numpy as np

__all__ = [
    'parse_node_value', 'principled_to_material', 'light_to_pool_entry',
    'world_background', 'PRINCIPLED_SOCKETS', 'RENDER_PASSES',
    'ViewportRefiner', 'classify_updates', 'sync_worker', 'viewport_pass',
    'register', 'unregister',
]

ENGINE_ID = 'PTINA_TPU_TORCH'

# Principled BSDF socket names in MATERIAL_PARAMS order
# (reference blender.py:449-462).
PRINCIPLED_SOCKETS = (
    'Base Color', 'Metallic', 'Roughness', 'Specular', 'Specular Tint',
    'Subsurface', 'Sheen', 'Sheen Tint', 'Clearcoat', 'Clearcoat Roughness',
    'Transmission', 'IOR',
)

# (name, channels, type), film pass id = position
# (reference render_passes, blender.py:591-595)
RENDER_PASSES = (
    ('Combined', 'RGBA', 'COLOR'),
    ('Albedo', 'RGB', 'COLOR'),
    ('Normal', 'XYZ', 'VECTOR'),
)


def parse_node_value(value, get_image_id=None):
    '''One shader-socket value -> (factor[4], texture_id).

    value is either a plain scalar, a color sequence, or a texture-node
    object exposing `.image` (ShaderNodeTexImage / TexEnvironment —
    reference blender.py:429-440).  get_image_id maps an image object to
    a pool texture id.'''
    if hasattr(value, 'image'):
        texid = get_image_id(value.image) if get_image_id else -1
        return [1.0, 1.0, 1.0, 1.0], texid
    if hasattr(value, 'bl_idname') or hasattr(value, 'inputs'):
        raise ValueError('only image/environment texture nodes are '
                         'supported as socket inputs')
    if hasattr(value, '__iter__'):
        fac = [float(x) for x in value]
        return (fac + [1.0] * 4)[:4], -1
    return [float(value)] * 4, -1


def principled_to_material(socket_values, get_image_id=None):
    '''dict {socket name: value} -> 12-tuple of (factor, texid) pairs in
    MATERIAL_PARAMS order — the worker.load_materials format
    (reference __parse_material, blender.py:416-464).'''
    out = []
    for name in PRINCIPLED_SOCKETS:
        fac, tex = parse_node_value(socket_values[name], get_image_id)
        out.append((np.asarray(fac[:4], np.float32), tex))
    return out


def light_to_pool_entry(world, color, energy, light_type, size):
    '''Blender light datablock values -> worker.add_light arguments
    (reference __add_light_object, blender.py:330-351).

    world: 4x4 matrix; color: RGB; energy: watts; light_type:
    'POINT'|'AREA'; size: shadow_soft_size (point) or size/2 (area).
    Returns (world, radiance_color, size, type).'''
    color = np.asarray(color, np.float64) * float(energy)
    size = max(float(size), 1e-6)
    if light_type == 'POINT':
        # sphere emitter of radius `size`: L = P / (4 pi^2 r^2)
        color = color / (4.0 * np.pi ** 2 * size ** 2)
    elif light_type == 'AREA':
        # one-sided Lambertian square of half-extent s: L = P / (4 pi s^2)
        color = color / (4.0 * np.pi * size ** 2)
    else:
        raise ValueError(f'unsupported light type {light_type!r}')
    return np.asarray(world, np.float64), color.astype(np.float32), size, light_type


def world_background(color_value, strength, get_image_id=None):
    '''Background node -> (factor[4], texture_id) for
    worker.set_world_light (reference __add_world, blender.py:374-414).'''
    fac, tex = parse_node_value(color_value, get_image_id)
    s = float(strength)
    return [x * s for x in fac], tex


def classify_updates(updates, live_object_names):
    '''Decide what a depsgraph update batch means for the scene pools
    (pure core of the reference __update_scene, blender.py:502-554).

    updates: iterable of (kind, name) where kind is 'MATERIAL' | 'WORLD'
    | 'OBJECT_MESH' | 'OBJECT_LIGHT' | 'SCENE'; live_object_names: the
    current set of object names in the scene (used to detect removals
    against a previously-known set is the caller's job — SCENE updates
    simply request a prune).

    Returns dict(materials=[names], world=bool, meshes=[names],
    lights=[names], prune=bool).'''
    out = {'materials': [], 'world': False, 'meshes': [], 'lights': [],
           'prune': False}
    for kind, name in updates:
        if kind == 'MATERIAL':
            out['materials'].append(name)
        elif kind == 'WORLD':
            out['world'] = True
        elif kind == 'OBJECT_MESH':
            out['meshes'].append(name)
        elif kind == 'OBJECT_LIGHT':
            out['lights'].append(name)
        elif kind == 'SCENE':
            out['prune'] = True
    return out


class ViewportRefiner:
    '''Progressive viewport refinement state machine — the pure core of
    the reference my_draw (blender.py:713-784): render at
    1/start_pixel_size resolution first, double the resolution after
    every pass until full size, then accumulate samples up to
    max_samples.  Camera/scene changes reset the ladder.

    Drive it with next_action(...); it returns None (nothing to do) or
    dict(width, height, clear, pass_id, redraw) describing the render
    the engine should launch.'''

    def __init__(self, start_pixel_size=8, pixel_scale=1, max_samples=32):
        self.start_pixel_size = int(start_pixel_size)
        self.pixel_scale = max(1, int(pixel_scale))
        self.max_samples = int(max_samples)
        self.nsamples = 0
        self.nblocks = self.start_pixel_size
        self.dimensions = None
        self.perspective = None
        self.is_preview = None

    def reset(self):
        self.nsamples = 0
        self.nblocks = self.start_pixel_size

    def next_action(self, dimensions, perspective, is_preview=False):
        '''dimensions: (w, h) region pixels; perspective: hashable camera
        key (matrix bytes); is_preview: MATERIAL shading mode.'''
        changed = (self.dimensions != dimensions
                   or self.perspective != perspective
                   or self.is_preview != is_preview)
        if changed:
            self.dimensions = dimensions
            self.perspective = perspective
            self.is_preview = is_preview
            self.reset()
        if self.nsamples >= self.max_samples:
            return None

        w, h = dimensions
        scale = max(1, self.nblocks) * self.pixel_scale
        width = max(1, w // scale)
        height = max(1, h // scale)

        if self.nblocks > 1:
            # refinement ladder: every pass restarts at a finer size
            clear = True
            self.nsamples = 0
        else:
            clear = self.nblocks == 1  # final ladder step: fresh accumulator
            self.nsamples += 1
        redraw = self.nsamples < self.max_samples or self.nblocks != 0
        self.nblocks //= 2
        return dict(width=width, height=height, clear=clear,
                    pass_id=1 if is_preview else 0, redraw=redraw)


def sync_worker(worker, materials, images, meshes, world_light, lights):
    '''Upload a synced scene to `worker` (the worker module or a
    DaemonModule over it) in the reference's _on_update order
    (blender.py:555-582): materials, images, the meshes composed into one
    model (io.multimesh) and its tree, the world light, then the lights.
    meshes: (p, n, t, world, mtlid) per object; lights: add_light
    argument tuples.'''
    from ptina_tpu_torch.io.multimesh import compose_multiple_meshes
    worker.load_materials(materials)
    worker.load_images(images)
    if meshes:
        verts, mtlids = compose_multiple_meshes(meshes)
        worker.load_model(verts, mtlids)
        worker.build_tree()
    if world_light is not None:
        worker.set_world_light(*world_light)
    worker.clear_lights()
    for w, c, s, t in lights:
        worker.add_light(w, c, s, t)


def viewport_pass(worker, act, persp):
    '''One rung of the viewport ladder (a ViewportRefiner action) on
    `worker`: resize, set the camera, clear if asked, render the pass
    (the AOVs for pass 1, a path sample otherwise) and export it.
    Returns ((w, h), pixels [w * h * 3] float32).'''
    worker.set_size(act['width'], act['height'])
    worker.set_camera(persp)
    if act['clear']:
        worker.clear(act['pass_id'])
    if act['pass_id'] == 1:
        worker.render_preview()
    else:
        worker.render()
    w, h = worker.get_size()
    buf = np.empty(w * h * 3, np.float32)
    worker.fast_export_image(buf, act['pass_id'])
    return (w, h), buf


# --------------------------------------------------------------------------
# Everything below needs bpy / gpu and only runs inside Blender.
# --------------------------------------------------------------------------

def _build_engine_class():
    import bpy
    from ptina_tpu_torch import worker as _worker
    from ptina_tpu_torch.utils.daemon import DaemonModule

    worker = DaemonModule(_worker)

    class PtinaTorchRenderEngine(bpy.types.RenderEngine):
        '''reference TinaRenderEngine (blender.py:283-806).'''
        bl_idname = ENGINE_ID
        bl_label = 'Ptina Torch (CUDA)'
        bl_use_preview = True

        def __init__(self):
            super().__init__()
            self._images = []
            self._image_names = []
            self._materials = []
            self._material_names = []
            # depsgraph-diff caches (reference object_to_mesh/_light)
            self._object_to_mesh = {}
            self._object_to_light = {}
            self._world_light = None
            self._scene_data = False
            # viewport state
            self._refiner = None
            self._draw_data = None
            self._closed_draws = []
            self._waiting = False
            self._viewport_error = None

        # ---- scene sync ----
        def _get_image_id(self, image):
            if image is None:
                return -1
            if image.name not in self._image_names:
                w, h = image.size
                px = np.array(image.pixels[:], np.float32).reshape(h, w, 4)
                self._image_names.append(image.name)
                self._images.append(px.transpose(1, 0, 2))
            return self._image_names.index(image.name)

        def _socket_value(self, node, name):
            sock = node.inputs[name]
            if sock.is_linked:
                return sock.links[0].from_node
            return sock.default_value

        def _add_mesh_object(self, obj, depsgraph):
            '''Triangulate + extract one mesh object into the diff cache
            (reference __add_mesh_object, blender.py:313-329).'''
            ev = obj.evaluated_get(depsgraph)
            mesh = ev.to_mesh()
            mesh.calc_loop_triangles()
            try:
                mesh.calc_normals_split()
            except AttributeError:
                pass  # 4.1+: split normals always available
            n = len(mesh.loop_triangles)
            verts = np.zeros((n * 3, 8), np.float32)
            tri_loops = np.array(
                [lt.loops for lt in mesh.loop_triangles]).reshape(-1)
            vidx = np.array(
                [mesh.loops[l].vertex_index for l in tri_loops])
            co = np.array([v.co for v in mesh.vertices], np.float32)
            verts[:, 0:3] = co[vidx]
            verts[:, 3:6] = np.array(
                [mesh.loops[l].normal for l in tri_loops], np.float32)
            if mesh.uv_layers.active:
                uv = mesh.uv_layers.active.data
                verts[:, 6:8] = np.array(
                    [uv[l].uv for l in tri_loops], np.float32)
            mtlid = None
            if obj.active_material:
                mtlid = self._add_material(obj.active_material)
            self._object_to_mesh[obj.name] = (
                verts[:, 0:3].reshape(n, 3, 3),
                verts[:, 3:6].reshape(n, 3, 3),
                verts[:, 6:8].reshape(n, 3, 2),
                np.array(obj.matrix_world, np.float64), mtlid)
            ev.to_mesh_clear()

        def _add_light_object(self, obj):
            d = obj.data
            if d.type not in ('POINT', 'AREA'):
                return
            size = (max(d.shadow_soft_size, 1e-6)
                    if d.type == 'POINT' else max(d.size / 2, 1e-6))
            self._object_to_light[obj.name] = light_to_pool_entry(
                np.array(obj.matrix_world), d.color, d.energy, d.type, size)

        def _add_world(self, world):
            if world and world.node_tree:
                out = world.node_tree.nodes.get('World Output')
                if out is not None:
                    bg = self._socket_value(out, 'Surface')
                    if hasattr(bg, 'inputs'):
                        self._world_light = world_background(
                            self._socket_value(bg, 'Color'),
                            self._socket_value(bg, 'Strength'),
                            self._get_image_id)

        def _add_material(self, material, force=False):
            if material.name in self._material_names and not force:
                return self._material_names.index(material.name)
            tree = material.node_tree
            out = tree.nodes.get('Material Output')
            bsdf = self._socket_value(out, 'Surface')
            vals = {n: self._socket_value(bsdf, n)
                    for n in PRINCIPLED_SOCKETS}
            mat = principled_to_material(vals, self._get_image_id)
            if material.name in self._material_names:
                self._materials[self._material_names.index(material.name)] = mat
                return self._material_names.index(material.name)
            self._material_names.append(material.name)
            self._materials.append(mat)
            return len(self._materials) - 1

        def _setup_scene(self, depsgraph):
            '''Full sync (reference __setup_scene, blender.py:478-500).'''
            self._object_to_mesh.clear()
            self._object_to_light.clear()
            self._add_world(depsgraph.scene.world)
            for obj in depsgraph.objects:
                if obj.type == 'MESH':
                    self._add_mesh_object(obj, depsgraph)
                elif obj.type == 'LIGHT':
                    self._add_light_object(obj)
            self._on_update()

        def _update_scene(self, depsgraph):
            '''Incremental sync from depsgraph.updates (reference
            __update_scene, blender.py:502-554).'''
            updates = []
            for update in depsgraph.updates:
                o = update.id
                if isinstance(o, bpy.types.Material):
                    updates.append(('MATERIAL', o.name))
                elif isinstance(o, bpy.types.World):
                    if depsgraph.scene.world \
                            and depsgraph.scene.world.name == o.name:
                        updates.append(('WORLD', o.name))
                elif isinstance(o, bpy.types.Scene):
                    updates.append(('SCENE', o.name))
                elif isinstance(o, bpy.types.Object):
                    if o.type == 'MESH':
                        updates.append(('OBJECT_MESH', o.name))
                    elif o.type == 'LIGHT':
                        updates.append(('OBJECT_LIGHT', o.name))
            live = {o.name for o in depsgraph.scene.objects}
            plan = classify_updates(updates, live)

            need = False
            for name in plan['materials']:
                mat = bpy.data.materials.get(name)
                if mat is not None:
                    self._add_material(mat, force=True)
                    need = True
            if plan['world']:
                self._add_world(depsgraph.scene.world)
                need = True
            if plan['prune']:
                for cache in (self._object_to_mesh, self._object_to_light):
                    for gone in [n for n in cache if n not in live]:
                        del cache[gone]
                        need = True
            for name in plan['meshes']:
                obj = depsgraph.scene.objects.get(name)
                if obj is not None:
                    self._add_mesh_object(obj, depsgraph)
                    need = True
            for name in plan['lights']:
                obj = depsgraph.scene.objects.get(name)
                if obj is not None:
                    self._add_light_object(obj)
                    need = True
            if need:
                self._on_update()
            return need

        def _on_update(self):
            '''Upload the diff caches to the worker pools (reference
            __on_update, blender.py:555-582).'''
            sync_worker(worker, self._materials, self._images,
                        list(self._object_to_mesh.values()),
                        self._world_light,
                        list(self._object_to_light.values()))
            if self._refiner is not None:
                self._refiner.reset()

        def _props(self, scene):
            return getattr(scene, 'ptina_torch_render', None)

        # ---- final render (reference blender.py:599-660) ----
        def render(self, depsgraph):
            import time
            scene = depsgraph.scene
            props = self._props(scene)
            scale = scene.render.resolution_percentage / 100.0
            nx = int(scene.render.resolution_x * scale)
            ny = int(scene.render.resolution_y * scale)

            for name, channels, _ in RENDER_PASSES:
                if name not in ('Combined', 'Depth'):
                    self.add_pass(name, len(channels), channels)

            worker.init()
            self._setup_scene(depsgraph)
            worker.set_size(nx, ny)
            cam = scene.camera
            proj = np.array(cam.calc_matrix_camera(depsgraph, x=nx, y=ny))
            view = np.linalg.inv(np.array(cam.matrix_world))
            worker.set_camera(proj @ view)

            nsamples = props.render_samples if props else 128
            albedo_samples = props.albedo_samples if props else 1
            interval = props.update_interval if props else 10.0

            result = self.begin_result(0, 0, nx, ny)
            layer = result.layers[0]
            t0 = time.time()
            for samp in range(nsamples):
                if self.test_break():
                    break
                self.update_stats('Rendering', f'{samp}/{nsamples} Samples')
                self.update_progress((samp + 0.5) / nsamples)
                worker.render()
                if samp < max(albedo_samples, 1):
                    worker.render_preview()
                if (time.time() - t0 > interval or samp == 0
                        or samp == nsamples - 1):
                    self._export_passes(layer)
                    self.update_result(result)
                    t0 = time.time()
            self._export_passes(layer)
            self.end_result(result)

        def _export_passes(self, layer):
            '''Write every registered film pass into the RenderResult
            (reference blender.py:644-655).'''
            for pid, (name, channels, _) in enumerate(RENDER_PASSES):
                if name not in layer.passes:
                    continue
                img = worker.get_image(pid)
                img = np.ascontiguousarray(img.swapaxes(0, 1))
                img = img.reshape(-1, 4)
                if len(channels) != 4:
                    img = img[:, :len(channels)]
                layer.passes[name].rect = img.tolist()

        def update_render_passes(self, scene=None, renderlayer=None):
            '''Pass declaration for compositor/denoise consumers
            (reference blender.py:661-664).'''
            for name, channels, ptype in RENDER_PASSES:
                self.register_pass(scene, renderlayer, name,
                                   len(channels), channels, ptype)

        # ---- viewport (reference blender.py:674-806) ----
        def view_update(self, context, depsgraph):
            if not self._scene_data:
                self._scene_data = True
                self._setup_scene(depsgraph)
            else:
                self._update_scene(depsgraph)

        def view_draw(self, context, depsgraph):
            import gpu
            from gpu_extras.presets import draw_texture_2d
            if self._viewport_error is not None:
                err, self._viewport_error = self._viewport_error, None
                raise err
            scene = depsgraph.scene
            props = self._props(scene)
            if self._refiner is None:
                self._refiner = ViewportRefiner(
                    start_pixel_size=props.start_pixel_size if props else 8,
                    pixel_scale=props.pixel_scale if props else 1,
                    max_samples=props.viewport_samples if props else 32)

            region = context.region
            region3d = context.region_data
            dims = (region.width, region.height)
            persp = np.array(region3d.perspective_matrix.to_4x4())
            is_preview = context.space_data.shading.type == 'MATERIAL'

            if not self._waiting:
                act = self._refiner.next_action(
                    dims, persp.tobytes(), is_preview)
                if act is not None:
                    self._waiting = True

                    def waiter():
                        try:
                            res, buf = viewport_pass(worker, act, persp)
                            old = self._draw_data
                            self._draw_data = _DrawData(dims, res, buf)
                            if old is not None:
                                self._closed_draws.append(old)
                            if act['redraw']:
                                self.tag_redraw()
                        except BaseException as e:  # noqa: BLE001
                            # raised by the next view_draw
                            self._viewport_error = e
                        finally:
                            self._waiting = False

                    threading.Thread(target=waiter, name='ptina-viewport',
                                     daemon=True).start()

            gpu.state.blend_set('ALPHA_PREMULT')
            self.bind_display_space_shader(scene)
            self._closed_draws.clear()  # GPU textures are GC-managed
            if self._draw_data is not None:
                draw_texture_2d(self._draw_data.texture, (0, 0),
                                *self._draw_data.dimensions)
            self.unbind_display_space_shader()
            gpu.state.blend_set('NONE')

    class _DrawData:
        '''Viewport pixel buffer -> GPU texture (reference TinaDrawData,
        blender.py:810-897, re-done with the gpu module: bgl is gone in
        Blender 4.x and GPUTexture handles lifetime + sampling).'''

        def __init__(self, dimensions, res, pixels):
            import gpu
            self.dimensions = dimensions
            w, h = res
            rgba = np.ones((h, w, 4), np.float32)
            rgba[:, :, :3] = pixels.reshape(w, h, 3).swapaxes(0, 1)
            buf = gpu.types.Buffer('FLOAT', w * h * 4, rgba.reshape(-1))
            self.texture = gpu.types.GPUTexture((w, h), format='RGBA16F',
                                                data=buf)

    return PtinaTorchRenderEngine


_classes = []


def register():
    '''Register engine + properties + panels (reference blender.py:933-948).'''
    import bpy
    global _classes

    class PtinaTorchRenderProperties(bpy.types.PropertyGroup):
        '''reference TinaRenderProperties (blender.py:922-931).'''
        render_samples: bpy.props.IntProperty(
            name='Render Samples', min=1, default=128)
        viewport_samples: bpy.props.IntProperty(
            name='Viewport Samples', min=1, default=32)
        albedo_samples: bpy.props.IntProperty(
            name='Albedo Samples', min=0, default=1)
        start_pixel_size: bpy.props.IntProperty(
            name='Start Pixel Size', min=1, default=8, subtype='PIXEL')
        pixel_scale: bpy.props.IntProperty(
            name='Pixel Scale', min=1, default=1, subtype='PIXEL')
        update_interval: bpy.props.FloatProperty(
            name='Update Interval', min=0, default=10, subtype='TIME')

    class PTINA_TORCH_RENDER_PT_sampling(bpy.types.Panel):
        '''reference TinaRenderPanel (blender.py:904-920).'''
        bl_label = 'Ptina Torch Sampling'
        bl_space_type = 'PROPERTIES'
        bl_region_type = 'WINDOW'
        bl_context = 'render'
        COMPAT_ENGINES = {ENGINE_ID}

        @classmethod
        def poll(cls, context):
            return context.engine == ENGINE_ID

        def draw(self, context):
            props = context.scene.ptina_torch_render
            col = self.layout.column()
            for attr in ('render_samples', 'viewport_samples',
                         'albedo_samples', 'start_pixel_size',
                         'pixel_scale', 'update_interval'):
                col.prop(props, attr)

    engine = _build_engine_class()
    _classes = [PtinaTorchRenderProperties, PTINA_TORCH_RENDER_PT_sampling,
                engine]
    for cls in _classes:
        bpy.utils.register_class(cls)
    bpy.types.Scene.ptina_torch_render = bpy.props.PointerProperty(
        name='ptina_tpu_torch', type=PtinaTorchRenderProperties)

    # reuse Cycles UI panels (reference get_panels, blender.py:904-920)
    for panel in _get_compatible_panels():
        panel.COMPAT_ENGINES.add(ENGINE_ID)


def _get_compatible_panels():
    import bpy
    exclude = {'VIEWLAYER_PT_filter', 'VIEWLAYER_PT_layer_passes'}
    panels = []
    for panel in bpy.types.Panel.__subclasses__():
        if not hasattr(panel, 'COMPAT_ENGINES'):
            continue
        if 'CYCLES' not in panel.COMPAT_ENGINES:
            continue
        if panel.__name__ in exclude:
            continue
        panels.append(panel)
    return panels


def unregister():
    import bpy
    for panel in _get_compatible_panels():
        panel.COMPAT_ENGINES.discard(ENGINE_ID)
    for cls in reversed(_classes):
        bpy.utils.unregister_class(cls)
    if hasattr(bpy.types.Scene, 'ptina_torch_render'):
        del bpy.types.Scene.ptina_torch_render
